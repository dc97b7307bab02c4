// Batch-norm forward with an optional folded relu, over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_norm.py:_bn_fwd_kernel
// (pallas_call in _bn_forward). Same function: per-channel moments of x
// over its N = B*H*W rows in f32 -- one-pass E[x^2] - E[x]^2 clamped at
// 0, or with two_pass the mean first and then E[(x - mean)^2] -- then
// y = ((x - mean) * rstd) * gamma + beta, rstd = rsqrt(var + eps), an
// optional relu, and y rounded to the dtype of x. mean, var and rstd come
// out in f32 (the running-statistic EMA reads mean and var, the backward
// mean and rstd).
//
// Bound on the H100 (3.35 TB/s): the bytes that must move, x read once
// and y written once, 2 * N * C * sizeof(T). For bn_stem1 at batch 128
// (N * C = 128 * 112 * 112 * 64, bf16) that is 411 MB, 0.123 ms. No
// design reaches it there: the moments must see every row before the
// first y, and x (205.5 MB) does not stay in the 50 MB L2 between them,
// so x is read twice: 616.5 MB, 0.184 ms.
//
// Design: two launches one-pass, three two-pass, and no finalize kernel.
// The moments are one launch of colsum_vec.cuh's column sums with
// bn_moments.cuh's MomentsVec op (sum x and sum x^2 into a (2, C)
// buffer, bit-equal to bn_sums' on the same rows); two-pass takes sum x
// (MomentsVec with one sum), then sum (x - mean)^2 (SqDevVec, which forms
// mean = sum x / N once a thread). The normalize, bn_fwd_norm_vec, is
// bn_norm_vec.cuh's walk (a thread keeps one 16-byte channel group and
// its constants in registers, stride a multiple of C): each thread forms
// its channels' mean, var and rstd from the raw sums with bn_moments.cuh's
// formula, and the threads of row lane 0 write them out. No float
// atomics: reruns agree bit for bit. The normalize's operations are the
// rounded f32 operations of the plain version in its order, so y is
// bit-equal to bn_norm_plain with the kernel's own mean and rstd on
// finite inputs; a NaN in a channel gives that channel NaN moments, as
// the plain version and the TPU kernel do.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py --ab): 0.2230
// ms at bn_stem1 one-pass, 1.82x its bound (by launch the moments 83.0
// us, 2.48 TB/s, and the normalize 139.0 us, 2.96 TB/s), 0.2987 two-pass,
// 0.01769 at a mid layer (25,088 x 256; 8.5 and 8.7 us by launch). The
// design it replaced (a scalar two-stage column sum, a one-thread-a-
// channel finalize, a scalar grid-stride normalize: three launches) took
// 0.4058, 0.4925 and 0.02806 ms there in the same call.
#include "bn_moments.cuh"
#include "bn_norm_vec.cuh"

// The normalize with the statistics formed from the raw sums: sums (2, C)
// = (sum x, sum x^2), or with TWO_PASS (sum x, sum (x - mean)^2); stats
// (3, C) = mean, var, rstd, written by the threads of row lane 0. The walk
// is bn_norm_vec's.
template <typename T, int V, bool RELU, bool TWO_PASS>
__global__ void __launch_bounds__(kNormThreads, kNormCtasPerSm)
    bn_fwd_norm_vec(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ sums, float n, float eps,
                    float* __restrict__ stats, T* __restrict__ y,
                    int64_t nv, int groups, int64_t lanes) {
  const int64_t stride = lanes * groups;
  const int64_t t = (int64_t)blockIdx.x * kNormThreads + threadIdx.x;
  if (t >= stride) return;
  const int C = groups * V;
  const int c0 = (int)(t % groups) * V;
  NormOp<V, RELU> op;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float mean = bn_mean(sums[c0 + j], n);
    const float var = TWO_PASS ? __fdiv_rn(sums[C + c0 + j], n)
                               : bn_var(sums[C + c0 + j], n, mean);
    op.km[j] = mean;
    op.kr[j] = bn_rstd(var, eps);
    op.kg[j] = gamma[c0 + j];
    op.kb[j] = beta[c0 + j];
    if (t < groups) {
      stats[c0 + j] = mean;
      stats[C + c0 + j] = var;
      stats[2 * C + c0 + j] = op.kr[j];
    }
  }
  norm_walk<T, V>(x, y, t, stride, nv, op);
}

template <typename T, int V, bool RELU, bool TWO_PASS>
static void launch_fwd_norm(const void* x, const float* gamma,
                            const float* beta, const float* sums, float n,
                            float eps, float* stats, void* y, int64_t nv,
                            int groups, int64_t lanes, int blocks,
                            cudaStream_t s) {
  bn_fwd_norm_vec<T, V, RELU, TWO_PASS><<<blocks, kNormThreads, 0, s>>>(
      (const T*)x, gamma, beta, sums, n, eps, stats, (T*)y, nv, groups,
      lanes);
}

template <typename T>
static int run(const void* x, const float* gamma, const float* beta,
               void* y, float* stats, float* sums, float* part,
               unsigned* counters, int64_t N, int C, int vec, int cgt,
               int tiles, int blocks, int64_t rows_per, int fvec,
               int64_t lanes, int nblocks, int relu, int two_pass,
               float eps, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (!norm_plan_ok<T>(x, y, N, C, vec, lanes, nblocks))
    return (int)cudaErrorInvalidValue;
  int rc = launch_moments<T>(x, sums, part, counters, N, C, vec, cgt, tiles,
                             blocks, rows_per, fvec,
                             two_pass ? kSumX : kSumsX2, s);
  if (rc == 0 && two_pass)
    rc = launch_moments<T>(x, sums, part, counters, N, C, vec, cgt, tiles,
                           blocks, rows_per, fvec, kSqDev, s);
  if (rc != 0) return rc;
  const int groups = C / vec;
  const int64_t nv = N * C / vec;
  const float n = (float)N;
#define FWD_NORM(V_, RELU_, TWO_)                                           \
  launch_fwd_norm<T, V_, RELU_, TWO_>(x, gamma, beta, sums, n, eps, stats, \
                                      y, nv, groups, lanes, nblocks, s)
#define FWD_NORM_V(V_)                                                    \
  if (two_pass) {                                                         \
    if (relu) FWD_NORM(V_, true, true); else FWD_NORM(V_, false, true);   \
  } else {                                                                \
    if (relu) FWD_NORM(V_, true, false); else FWD_NORM(V_, false, false); \
  }
  if (vec == VW) {
    FWD_NORM_V(VW)
  } else {
    FWD_NORM_V(1)
  }
#undef FWD_NORM_V
#undef FWD_NORM
  return 0;
}

// x, y: (N, C) contiguous of dtype code `dtype`; gamma, beta: (C,) f32;
// stats: (3, C) f32 output, mean, var and rstd; sums: (2, C) f32 output,
// the sums the statistics were formed from (sum x and sum x^2, or with
// two_pass sum x and sum (x - mean)^2); part: blocks * 2 * C f32 scratch;
// counters: `tiles` zero unsigned ints, left zero. vec, cgt, tiles,
// blocks, rows_per, fvec: ops/fused_norm.colsum_vec_plan; lanes, nblocks:
// ops/fused_norm.bn_dx_plan (same vec). Returns a cudaError_t (0 =
// launched).
extern "C" int bn_fwd(const void* x, const float* gamma, const float* beta,
                      void* y, float* stats, float* sums, float* part,
                      unsigned* counters, int64_t N, int C, int vec, int cgt,
                      int tiles, int blocks, int64_t rows_per, int fvec,
                      int64_t lanes, int nblocks, int dtype, int relu,
                      int two_pass, float eps, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = run<T>(x, gamma, beta, y, stats, sums, part,
                              counters, N, C, vec, cgt, tiles, blocks,
                              rows_per, fvec, lanes, nblocks, relu, two_pass,
                              eps, s));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* bn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
