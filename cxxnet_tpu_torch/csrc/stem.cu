// uint8 decode-normalize: y = (float(x) - mean) * factor, cast once to the
// output dtype.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_stem.py:_stem_kernel (its
// pallas_call in _stem_call). Same function on a uint8 batch viewed as
// (B, cols) rows, cols = H*W*C: convert to f32, subtract the mean (none,
// one per channel, or a mean image of H*W*C), multiply by the factor,
// round once to f32, bf16 or f16 (round to nearest even). The subtract
// and the multiply are two f32 roundings (__fsub_rn, __fmul_rn: never
// contracted or reassociated), so the result is bit-equal to the plain
// version; without a mean the subtracted 0 changes no value.
//
// Bound on the H100 (3.35 TB/s): bytes. At the Inception-BN train path
// (128 x 224x224x3 uint8 to bf16, a 224x224x3 f32 mean image) the kernel
// reads 19.3 MB and the mean's 0.6 MB and writes 38.5 MB: 17.4 us.
//
// The first design (a flat grid-stride walk, 16 elements a thread and
// trip, each element's mean gathered as a scalar __ldg at a 64-bit
// remainder, the mean image read again for every image: 77 MB out of the
// L2) took 45.0 us there on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py).
//
// Design. A thread owns one vector of V columns, V the elements of one
// 16-byte store of y (8 for bf16 and f16, 4 for f32; the wrapper's plan,
// ops/fused_stem.stem_plan, narrows it where cols or a base forbids), and
// walks rows of the batch. The column vector's mean values are the same
// in every row (the mean's length divides cols), so the thread reads them
// once into registers, at one remainder of its first column; none is 0.
// Then it walks its rows, kRowsInFlight rows' x loads issued before the
// first store, with nothing in the row loop that divides. A block is
// bx x by threads, x across column vectors and y across rows; the grid
// is column blocks by row groups of by * rows rows. Any B, H, W, C is
// taken. At the path shape the plan gives 256 threads a block and 4 rows
// a thread, so the mean image is read 32 times (19 MB out of the L2, not
// 77). This design takes 22.2 us there with any of the three means on the
// same card (2.62 TB/s, 1.27x its bound; chip_smoke.py --ab): 4 rows a
// thread against 23.3 at 2 rows and 24.6 at 16 (a grid of 1.1 waves), 16
// columns a thread (one 16-byte load of x, 118 registers) 26.0 or more.
#include "common.cuh"

constexpr int kRowsInFlight = 4;   // x loads a thread issues before a store
constexpr int kMaxThreads = 512;
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ mean,
            int64_t mean_len, float f, T* __restrict__ y, int64_t n,
            int64_t cols, int rows) {
  using XV = VecOf<uint8_t, V>;
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col0 >= cols) return;
  float m[V];
  if (mean != nullptr) {
    int64_t mi = col0 < UINT32_MAX && mean_len < UINT32_MAX
                     ? (int64_t)((uint32_t)col0 % (uint32_t)mean_len)
                     : col0 % mean_len;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = __ldg(mean + mi);
      if (++mi == mean_len) mi = 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = 0.f;
  }
  const int by = blockDim.y;
  int64_t r = (int64_t)blockIdx.y * by * rows + threadIdx.y;
  const int64_t step = (int64_t)by * cols;
  const uint8_t* xp = x + r * cols + col0;
  T* yp = y + r * cols + col0;
  for (int j0 = 0; j0 < rows; j0 += kRowsInFlight) {
    XV v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (j0 + u < rows && r + u * by < n)
        v[u] = *reinterpret_cast<const XV*>(xp + u * step);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (j0 + u < rows && r + u * by < n) {
        VecOf<T, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k)
          out.v[k] = from_f32<T>(
              __fmul_rn(__fsub_rn((float)v[u].v[k], m[k]), f));
        *reinterpret_cast<VecOf<T, V>*>(yp + u * step) = out;
      }
    }
    xp += kRowsInFlight * step;
    yp += kRowsInFlight * step;
    r += kRowsInFlight * by;
  }
}

template <typename T>
static int stem_typed(const void* x, const void* mean, int64_t mean_len,
                      float f, void* y, int64_t n, int64_t cols, int vec,
                      int bx, int by, int rows, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (vec < 1 || vec > VW || (vec & (vec - 1)) || cols % vec ||
      (uintptr_t)x % vec || (uintptr_t)y % (vec * sizeof(T)) || bx < 1 ||
      by < 1 || bx * by > kMaxThreads || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t gx = (cols / vec + bx - 1) / bx;
  const int64_t gy = (n + (int64_t)by * rows - 1) / ((int64_t)by * rows);
  if (gx > INT32_MAX || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy), block(bx, by);
  const uint8_t* xs = (const uint8_t*)x;
  const float* ms = (const float*)mean;
  switch (vec) {
    case VW: stem_kernel<T, VW><<<grid, block, 0, s>>>(xs, ms, mean_len, f, (T*)y, n, cols, rows); break;
    case VW / 2: stem_kernel<T, VW / 2><<<grid, block, 0, s>>>(xs, ms, mean_len, f, (T*)y, n, cols, rows); break;
    case VW / 4: stem_kernel<T, VW / 4><<<grid, block, 0, s>>>(xs, ms, mean_len, f, (T*)y, n, cols, rows); break;
    default: stem_kernel<T, 1><<<grid, block, 0, s>>>(xs, ms, mean_len, f, (T*)y, n, cols, rows); break;
  }
  return 0;
}

// x: (n, cols) uint8, contiguous; mean: mean_len float32 (C per channel, or
// cols for a mean image; mean_len divides cols) or NULL; y: (n, cols) of
// dtype code `dtype`; vec, bx, by, rows: ops/fused_stem.stem_plan. Returns
// a cudaError_t (0 = launched).
extern "C" int stem(const void* x, const void* mean, int64_t mean_len,
                    float factor, void* y, int64_t n, int64_t cols, int dtype,
                    int vec, int bx, int by, int rows, void* stream) {
  if (n < 0 || cols < 0 ||
      (mean != nullptr && (mean_len <= 0 || cols % mean_len)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || cols == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  switch (dtype) {
    case kF32: rc = stem_typed<float>(x, mean, mean_len, factor, y, n, cols, vec, bx, by, rows, s); break;
    case kBF16: rc = stem_typed<__nv_bfloat16>(x, mean, mean_len, factor, y, n, cols, vec, bx, by, rows, s); break;
    case kF16: rc = stem_typed<__half>(x, mean, mean_len, factor, y, n, cols, vec, bx, by, rows, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* stem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
