// Cross-channel local response normalization, forward, over (N, C) rows
// (an NHWC node with C contiguous).
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_lrn.py:_lrn_fwd_kernel
// (pallas_call in _lrn_2d). Same function, f32 inside and one rounding to
// the dtype at the end:
//   win[c]  = sum of x[c']^2 over c' in [c - half, c + nsize - 1 - half],
//             zeros past the edges, half = nsize / 2
//   norm[c] = knorm + (alpha / nsize) * win[c]
//   y[c]    = x[c] * exp(-beta * log(norm[c]))
// The TPU sums the window as a matmul against a (C, C) band matrix to
// reach its matrix unit; here each output adds its nsize squares in
// ascending channel order, the order of the plain version, with no fused
// multiply-adds and expf/logf without fast math.
//
// Bound on the H100 (3.35 TB/s): bytes, x read once and y written once.
// At AlexNet's lrn1 (256, 27, 27, 96) bf16 that is 71.7 MB, 21.4 us; at
// lrn2 (256, 13, 13, 256) 44.3 MB, 13.2 us.
//
// Design: a block owns R rows by a chunk of CH channels (CH = min(C,
// 1024), R * CH about 2048 outputs). It stages x^2 in f32 in shared memory
// over the chunk and its window halo (nsize - 1 channels, zero outside
// [0, C)), then each thread computes outputs from shared memory; x is read
// a second time for the product (an L1/L2 hit). Loads and stores are
// coalesced along C. Any row count and any C are taken: the TPU kernel's
// C <= 1024 and row-block gates do not apply.
#include "common.cuh"

template <typename T>
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t n_rows, int C, int CH, int R,
                               int nsize, int half, float ab, float knorm,
                               float nbeta) {
  extern __shared__ float sq[];  // R x (CH + nsize - 1)
  const int W = CH + nsize - 1;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int c0 = blockIdx.y * CH;
  const int lo = c0 - half;  // channel held by sq[r * W + 0]
  for (int i = threadIdx.x; i < R * W; i += blockDim.x) {
    const int r = i / W, c = lo + i % W;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n_rows && c >= 0 && c < C) {
      v = to_f32(x[row * C + c]);
      v = __fmul_rn(v, v);
    }
    sq[i] = v;
  }
  __syncthreads();
  const int chn = min(CH, C - c0);
  for (int i = threadIdx.x; i < R * CH; i += blockDim.x) {
    const int r = i / CH, j = i % CH;
    const int64_t row = row0 + r;
    if (row >= n_rows || j >= chn) continue;
    const float* s = sq + r * W + j;  // window of channel c0 + j
    float win = 0.f;
    for (int k = 0; k < nsize; ++k) win = __fadd_rn(win, s[k]);
    const float norm = __fadd_rn(knorm, __fmul_rn(ab, win));
    const float p = expf(__fmul_rn(nbeta, logf(norm)));
    const int64_t off = row * C + c0 + j;
    y[off] = from_f32<T>(__fmul_rn(to_f32(x[off]), p));
  }
}

template <typename T>
static int launch(const void* x, void* y, int64_t n, int C, int nsize,
                  float ab, float knorm, float nbeta, cudaStream_t s) {
  const int CH = C < 1024 ? C : 1024;
  int R = 2048 / CH;
  R = R < 1 ? 1 : (R > 256 ? 256 : R);
  const size_t smem = (size_t)R * (CH + nsize - 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lrn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + R - 1) / R), (unsigned)((C + CH - 1) / CH));
  lrn_fwd_kernel<T><<<grid, 256, smem, s>>>((const T*)x, (T*)y, n, C, CH, R,
                                             nsize, nsize / 2, ab, knorm,
                                             nbeta);
  return (int)cudaGetLastError();
}

// x, y: (n_rows, C) contiguous of dtype code `dtype`. ab = alpha / nsize
// and nbeta = -beta, both rounded to float by the caller. Returns a
// cudaError_t (0 = launched).
extern "C" int lrn_fwd(const void* x, void* y, int64_t n_rows, int C,
                       int nsize, int dtype, float ab, float knorm,
                       float nbeta, void* stream) {
  if (C <= 0 || nsize <= 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<float>(x, y, n_rows, C, nsize, ab, knorm, nbeta, s);
    case kBF16: return launch<__nv_bfloat16>(x, y, n_rows, C, nsize, ab, knorm, nbeta, s);
    case kF16: return launch<__half>(x, y, n_rows, C, nsize, ab, knorm, nbeta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lrn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
