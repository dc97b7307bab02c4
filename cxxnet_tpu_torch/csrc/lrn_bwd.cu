// Cross-channel local response normalization, backward, over (N, C) rows
// (an NHWC node with C contiguous).
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_lrn.py:_lrn_bwd_kernel
// (pallas_call in _lrn_bwd). Same function, f32 inside and one rounding
// to the dtype at the end, with norm recomputed from x as the TPU kernel
// does (no saved intermediate):
//   norm[c] = knorm + (alpha / nsize) * (sum of x^2 over the window of c)
//   p[c]    = exp(-beta * log(norm[c]))              (norm^-beta)
//   t[j]    = dy[j] * x[j] * (p[j] / norm[j])
//   back[c] = sum of t[j] over the j whose window holds c, that is j in
//             [c - (nsize - 1 - half), c + half]  (the transposed window)
//   dx[c]   = dy[c] * p[c] - (2 * (alpha / nsize) * beta) * x[c] * back[c]
// For even nsize the forward window [c - half, c + nsize - 1 - half] and
// the transposed one differ; both sums run in ascending channel order,
// the plain version's order, with no fused multiply-adds.
//
// Bound on the H100 (3.35 TB/s): bytes, x and dy read once and dx written
// once. At AlexNet's lrn1 (256, 27, 27, 96) bf16 that is 107.5 MB,
// 32.1 us; at lrn2 (256, 13, 13, 256) 66.4 MB, 19.8 us.
//
// Design: a block owns R rows by a chunk of CH channels (CH = min(C,
// 1024)). Pass 0 stages x^2 in shared memory over the chunk widened by
// 2 * (nsize - 1) channels (the t halo's own windows); pass 1 computes p
// and t over the chunk widened by nsize - 1 channels (zero outside
// [0, C)); pass 2 sums t over each output's transposed window and writes
// dx. x and dy are read from device memory coalesced along C; the
// re-reads of the halo hit L1/L2. Any row count and any C are taken.
#include "common.cuh"

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy, T* __restrict__ dx,
                               int64_t n_rows, int C, int CH, int R,
                               int nsize, int half, float ab, float knorm,
                               float nbeta, float coef) {
  extern __shared__ float smem[];
  const int WT = CH + nsize - 1;       // t and p tile width
  const int WS = WT + nsize - 1;       // x^2 tile width
  float* sq = smem;                    // R x WS
  float* pp = sq + R * WS;             // R x WT
  float* tt = pp + R * WT;             // R x WT
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int c0 = blockIdx.y * CH;
  const int lo_t = c0 - (nsize - 1 - half);  // channel of tt[r * WT + 0]
  const int lo_s = lo_t - half;              // channel of sq[r * WS + 0]
  for (int i = threadIdx.x; i < R * WS; i += blockDim.x) {
    const int r = i / WS, c = lo_s + i % WS;
    const int64_t row = row0 + r;
    float v = 0.f;
    if (row < n_rows && c >= 0 && c < C) {
      v = to_f32(x[row * C + c]);
      v = __fmul_rn(v, v);
    }
    sq[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * WT; i += blockDim.x) {
    const int r = i / WT, jt = i % WT, c = lo_t + jt;
    const int64_t row = row0 + r;
    float p = 0.f, t = 0.f;
    if (row < n_rows && c >= 0 && c < C) {
      const float* s = sq + r * WS + jt;  // window of channel c
      float win = 0.f;
      for (int k = 0; k < nsize; ++k) win = __fadd_rn(win, s[k]);
      const float norm = __fadd_rn(knorm, __fmul_rn(ab, win));
      p = expf(__fmul_rn(nbeta, logf(norm)));
      const int64_t off = row * C + c;
      t = __fmul_rn(__fmul_rn(to_f32(dy[off]), to_f32(x[off])),
                    __fdiv_rn(p, norm));
    }
    pp[i] = p;
    tt[i] = t;
  }
  __syncthreads();
  const int chn = min(CH, C - c0);
  for (int i = threadIdx.x; i < R * CH; i += blockDim.x) {
    const int r = i / CH, j = i % CH;
    const int64_t row = row0 + r;
    if (row >= n_rows || j >= chn) continue;
    const float* t = tt + r * WT + j;  // transposed window of channel c0 + j
    float back = 0.f;
    for (int k = 0; k < nsize; ++k) back = __fadd_rn(back, t[k]);
    const float p = pp[r * WT + j + (nsize - 1 - half)];
    const int64_t off = row * C + c0 + j;
    const float xv = to_f32(x[off]);
    const float g = __fsub_rn(__fmul_rn(to_f32(dy[off]), p),
                              __fmul_rn(__fmul_rn(coef, xv), back));
    dx[off] = from_f32<T>(g);
  }
}

template <typename T>
static int launch(const void* x, const void* dy, void* dx, int64_t n, int C,
                  int nsize, float ab, float knorm, float nbeta, float coef,
                  cudaStream_t s) {
  const int CH = C < 1024 ? C : 1024;
  int R = 2048 / CH;
  R = R < 1 ? 1 : (R > 256 ? 256 : R);
  const size_t WT = (size_t)CH + nsize - 1, WS = WT + nsize - 1;
  const size_t smem = (size_t)R * (WS + 2 * WT) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lrn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + R - 1) / R), (unsigned)((C + CH - 1) / CH));
  lrn_bwd_kernel<T><<<grid, 256, smem, s>>>(
      (const T*)x, (const T*)dy, (T*)dx, n, C, CH, R, nsize, nsize / 2, ab,
      knorm, nbeta, coef);
  return (int)cudaGetLastError();
}

// x, dy, dx: (n_rows, C) contiguous of dtype code `dtype`. ab = alpha /
// nsize, nbeta = -beta and coef = 2 * (alpha / nsize) * beta, each rounded
// to float by the caller. Returns a cudaError_t (0 = launched).
extern "C" int lrn_bwd(const void* x, const void* dy, void* dx,
                       int64_t n_rows, int C, int nsize, int dtype, float ab,
                       float knorm, float nbeta, float coef, void* stream) {
  if (C <= 0 || nsize <= 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, s);
    case kF16:
      return launch<__half>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lrn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
