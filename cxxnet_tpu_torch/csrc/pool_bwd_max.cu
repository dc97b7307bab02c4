// First-match max pooling backward over exactly tiling windows or one
// global window, NHWC.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_pool.py:_pool_bwd_max_kernel
// (pallas_call in _bwd_call). Same function: for each output cell
// (b, oy, ox, c), the first cell of its kh x kw window in row-major order
// whose value equals the window's max y takes the whole dy; every other
// cell gets 0. With pre_relu (relu_max_pooling) the cells are relu(x) and
// a cell counts only if x > 0, so a window of non-positive values passes
// nothing. XLA's select-and-scatter has the same semantics. A NaN max
// matches no cell. x and dx are (B, H, W, C), y and dy (B, H/kh, W/kw, C).
//
// Bound on the H100 (3.35 TB/s): bytes, x, y and dy read once and dx
// written once. At the SPP net's spp1 (x (128, 27, 27, 256), 3x3/3,
// bf16) that is 47.8 + 5.3 + 5.3 + 47.8 MB, 31.7 us.
//
// The first design (one thread an output channel, its window's cells
// loaded one 2-byte scalar at a time, each compare waiting on its own
// load, 64-bit divisions per output) took 70.5 us there on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py): about 4 KB of loads in flight
// on a SM, 1.5 TB/s.
//
// Design. A thread takes V = 16 / sizeof(T) neighbouring channels of one
// output (one 16-byte vector; the wrapper's plan, ops/fused_pool
// .pool_bwd_max_plan, narrows V where C or a base forbids) and one row of
// its window: a block is bx x ry threads, x the output vector and y the
// window row. A thread loads y and dy once and all of its row's kw x
// vectors before its first compare (kw 2 and 3, the digits LeNet's and
// spp1's, compiled in; any other kw in chunks of kChunk vectors, in
// ascending order), and finds, lane by lane, the row's first cell equal
// to y. The rows' lane masks meet in shared memory: after one
// __syncthreads() a row clears the lanes an earlier row of the same
// output took, and stores its kw dx vectors, each lane dy or +0. Every
// dx cell is written exactly once: no atomics and no zero fill. A window
// taller than ry rows goes in rounds of ry rows, carrying the taken
// lanes. Output indices are 32-bit, divided once a thread; a batch whose
// output vectors pass 2^31 is launched in slices of whole images. This
// design takes 37.1 us at spp1 on the same card (2.86 TB/s, where a copy
// of x runs at 2.84; chip_smoke.py --ab), 1.17x its bound; 128 and 256
// threads a block time the same, 512 is 10 % slower. The compiled rows
// earn their place: the run-time row at kw 3 and 2 took 56.5 us at spp1
// and 2.8 us at the digits LeNet's 2x2 against their 37.1 and 2.3.
#include "common.cuh"

constexpr int kChunk = 4;            // x vectors a run-time row loads at once
constexpr int kMaxThreads = 512;     // bx * ry: one mask byte a thread

template <typename T, int V, int KW>
__global__ void __launch_bounds__(kMaxThreads)
pool_bwd_max_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    uint32_t n_vec, int H, int W, int C, int kh, int kw_rt,
                    int oy, int ox, int pre_relu) {
  using IO = VecIO<T, V>;
  using Raw = typename IO::Raw;
  __shared__ uint8_t masks[kMaxThreads];
  const int kw = KW ? KW : kw_rt;
  const int bx = blockDim.x, ry = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const uint32_t o = blockIdx.x * (uint32_t)bx + tx;
  const bool live = o < n_vec;
  const int64_t row_stride = (int64_t)W * C;
  int64_t off = 0;
  float ym[V];
  Raw g;
  if (live) {
    const uint32_t cvs = (uint32_t)(C / V);
    const uint32_t r = o / cvs, cv = o - r * cvs;
    const uint32_t q = r / (uint32_t)ox, j = r - q * ox;
    const uint32_t b = q / (uint32_t)oy, i = q - b * oy;
    off = (((int64_t)b * H + (int64_t)i * kh) * W + (int64_t)j * kw) * C +
          (int64_t)cv * V;
    const Raw yv = IO::load(y + (int64_t)o * V);
    g = IO::load(dy + (int64_t)o * V);
#pragma unroll
    for (int k = 0; k < V; ++k) ym[k] = IO::at(yv, k);
  }
  const T zero = from_f32<T>(0.f);
  uint32_t taken = 0;                 // lanes an earlier round's rows took
  const int rounds = (kh + ry - 1) / ry;
  for (int rd = 0; rd < rounds; ++rd) {
    const int u = rd * ry + ty;
    const bool mine = live && u < kh;
    int first[V];                     // the row's first matching column
#pragma unroll
    for (int k = 0; k < V; ++k) first[k] = -1;
    if (mine) {
      const T* row = x + off + u * row_stride;
      if constexpr (KW > 0) {
        Raw v[KW];
#pragma unroll
        for (int w = 0; w < KW; ++w) v[w] = IO::load(row + (int64_t)w * C);
#pragma unroll
        for (int w = 0; w < KW; ++w)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float e = IO::at(v[w], k);
            if (first[k] < 0 && e == ym[k] && (!pre_relu || e > 0.f))
              first[k] = w;
          }
      } else {
        for (int w0 = 0; w0 < kw; w0 += kChunk) {
          const int n = min(kChunk, kw - w0);
          Raw v[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            if (c < n) v[c] = IO::load(row + (int64_t)(w0 + c) * C);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float e = IO::at(v[c], k);
              if (c < n && first[k] < 0 && e == ym[k] &&
                  (!pre_relu || e > 0.f))
                first[k] = w0 + c;
            }
        }
      }
    }
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) bits |= (uint32_t)(first[k] >= 0) << k;
    masks[ty * bx + tx] = (uint8_t)bits;
    __syncthreads();
    uint32_t before = taken;
    for (int t = 0; t < ry; ++t) {
      const uint32_t m = masks[t * bx + tx];
      taken |= m;
      if (t < ty) before |= m;
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      if ((before >> k) & 1u) first[k] = -1;
    if (mine) {
      T* drow = dx + off + u * row_stride;
      auto store = [&](int w) {
        Raw out;
#pragma unroll
        for (int k = 0; k < V; ++k) out.v[k] = first[k] == w ? g.v[k] : zero;
        *reinterpret_cast<Raw*>(drow + (int64_t)w * C) = out;
      };
      if constexpr (KW > 0) {
#pragma unroll
        for (int w = 0; w < KW; ++w) store(w);
      } else {
        for (int w = 0; w < kw; ++w) store(w);
      }
    }
    if (rd + 1 < rounds) __syncthreads();   // the next round's masks
  }
}

template <typename T, int V, int KW>
static void launch(const T* x, const T* y, const T* dy, T* dx,
                   uint32_t n_vec, int H, int W, int C, int kh, int kw,
                   int pre_relu, int ry, int bx, cudaStream_t s) {
  const dim3 block(bx, ry);
  const unsigned grid = (unsigned)((n_vec + (uint32_t)bx - 1) / bx);
  pool_bwd_max_kernel<T, V, KW><<<grid, block, 0, s>>>(
      x, y, dy, dx, n_vec, H, W, C, kh, kw, H / kh, W / kw, pre_relu);
}

// the 16-byte vector with the digits LeNet's and spp1's rows compiled in;
// any narrower vector with the run-time row
template <typename T, int V>
static void launch_window(const T* x, const T* y, const T* dy, T* dx,
                          uint32_t n_vec, int H, int W, int C, int kh,
                          int kw, int pre_relu, int ry, int bx,
                          cudaStream_t s) {
  if constexpr (V == 16 / (int)sizeof(T)) {
    if (kw == 3)
      return launch<T, V, 3>(x, y, dy, dx, n_vec, H, W, C, kh, kw, pre_relu,
                             ry, bx, s);
    if (kw == 2)
      return launch<T, V, 2>(x, y, dy, dx, n_vec, H, W, C, kh, kw, pre_relu,
                             ry, bx, s);
  }
  launch<T, V, 0>(x, y, dy, dx, n_vec, H, W, C, kh, kw, pre_relu, ry, bx, s);
}

template <typename T>
static int pool_typed(const void* x, const void* y, const void* dy, void* dx,
                      int64_t B, int H, int W, int C, int kh, int kw,
                      int pre_relu, int vec, int ry, int bx, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)y | (uintptr_t)dy |
                          (uintptr_t)dx;
  if (vec < 1 || vec > VW || (vec & (vec - 1)) || C % vec ||
      bases % (vec * sizeof(T)) || ry < 1 || ry > kh || bx < 1 ||
      bx * ry > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t per_img = (int64_t)(H / kh) * (W / kw) * (C / vec);
  if (per_img == 0 || B == 0) return 0;
  if (per_img > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t imgs = INT32_MAX / per_img;   // a slice's images
  const int64_t in_img = (int64_t)H * W * C, out_img = per_img * vec;
  for (int64_t b0 = 0; b0 < B; b0 += imgs) {
    const uint32_t n_vec = (uint32_t)((B - b0 < imgs ? B - b0 : imgs) *
                                      per_img);
    const T* xs = (const T*)x + b0 * in_img;
    const T* ys = (const T*)y + b0 * out_img;
    const T* gs = (const T*)dy + b0 * out_img;
    T* ds = (T*)dx + b0 * in_img;
    switch (vec) {
      case VW: launch_window<T, VW>(xs, ys, gs, ds, n_vec, H, W, C, kh, kw, pre_relu, ry, bx, s); break;
      case VW / 2: launch_window<T, VW / 2>(xs, ys, gs, ds, n_vec, H, W, C, kh, kw, pre_relu, ry, bx, s); break;
      case VW / 4: launch_window<T, VW / 4>(xs, ys, gs, ds, n_vec, H, W, C, kh, kw, pre_relu, ry, bx, s); break;
      default: launch_window<T, 1>(xs, ys, gs, ds, n_vec, H, W, C, kh, kw, pre_relu, ry, bx, s); break;
    }
  }
  return 0;
}

// x, dx: (B, H, W, C); y, dy: (B, H/kh, W/kw, C); all contiguous of dtype
// code `dtype`; vec, ry, bx: ops/fused_pool.pool_bwd_max_plan. Returns a
// cudaError_t (0 = launched).
extern "C" int pool_bwd_max(const void* x, const void* y, const void* dy,
                            void* dx, int64_t B, int H, int W, int C, int kh,
                            int kw, int dtype, int pre_relu, int vec, int ry,
                            int bx, void* stream) {
  if (kh <= 0 || kw <= 0 || H % kh || W % kw || B < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  switch (dtype) {
    case kF32: rc = pool_typed<float>(x, y, dy, dx, B, H, W, C, kh, kw, pre_relu, vec, ry, bx, s); break;
    case kBF16: rc = pool_typed<__nv_bfloat16>(x, y, dy, dx, B, H, W, C, kh, kw, pre_relu, vec, ry, bx, s); break;
    case kF16: rc = pool_typed<__half>(x, y, dy, dx, B, H, W, C, kh, kw, pre_relu, vec, ry, bx, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* pool_bwd_max_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
