// Batch-norm backward with an optional folded relu, over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_norm.py:_bn_bwd_kernel
// (pallas_call in _bn_backward). Same function: with dy' = dy, masked by
// y > 0 when the relu was folded in, and x_hat = (x - mean) * rstd,
//   dbeta  = sum over rows of dy'          (f32, per channel)
//   dgamma = sum over rows of dy' * x_hat  (f32, per channel)
//   dx = gamma * rstd * (dy' - dbeta / N - x_hat * (dgamma / N)),
// rounded to the dtype of x. The gradients that mean and var receive are
// dropped (they feed the running-statistic EMA only).
//
// Bound on the H100 (3.35 TB/s): the bytes that must move, x, dy and (with
// relu) y read once and dx written once, 4 * N * C * sizeof(T) with relu,
// 3 * N * C * sizeof(T) without. For bn_stem1 at batch 128 (N * C =
// 128 * 112 * 112 * 64, bf16) with relu that is 822 MB, 0.245 ms; that
// needs the rows to stay on the chip between the sums and dx, and 616 MB
// do not fit in the 50 MB L2. Two passes move at least 7 streams (the
// sums read x, dy, y; dx reads them again and writes dx): 0.4294 ms.
//
// Design: two launches of bn_bwd_vec.cuh. The sums are the one-launch
// vectorised column sums of colsum_vec.cuh with the BwdSumsVec op, exactly
// as bn_bwd_sums (bn_sync.cu) takes them, so dgamma and dbeta are bit-equal
// to bn_bwd_sums' on the same rows; no float atomics, reruns agree bit for
// bit. With relu and 16-byte loads the sums pass also writes y > 0 as one
// byte of bits a vector, and the dx pass (bn_dx_vec) reads those bits in
// place of y: 6.125 streams, 0.3758 ms. The dx pass divides dbeta and
// dgamma by N once a channel and keeps every f32 operation in the plain
// version's order. At bn_stem1 on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py --ab): 0.4361 ms (the sums 0.2276 and dx 0.2067 by
// launch), 0.4760 with the dx pass reading y; the previous design
// (a scalar two-stage column sum, a one-CTA finalize, a scalar
// grid-stride dx loop) 0.7316, aten.native_batch_norm_backward 0.5010.
#include "bn_bwd_vec.cuh"

template <typename T>
static int run(const void* x, const void* dy, const void* y,
               const float* gamma, const float* mean, const float* rstd,
               void* dx, float* sums, float* part, unsigned* counters,
               uint8_t* bits, int64_t N, int C, int vec, int cgt, int tiles,
               int blocks, int64_t rows_per, int fvec, int64_t dx_lanes,
               int dx_blocks, cudaStream_t s) {
  const int rc = launch_bwd_sums<T>(x, dy, y, bits, mean, rstd, sums, part,
                                    counters, N, C, vec, cgt, tiles, blocks,
                                    rows_per, fvec, s);
  if (rc != 0) return rc;
  return launch_bn_dx<T>(x, dy, y, bits, gamma, mean, rstd, sums, sums + C,
                         (float)N, dx, N, C, vec, dx_lanes, dx_blocks, s);
}

// x, dy, dx: (N, C) contiguous of dtype code `dtype`; y: the forward's
// output (N, C) when the relu was folded in, else NULL; gamma, mean, rstd:
// (C,) f32; sums: (2, C) f32 output, row 0 dbeta and row 1 dgamma; part:
// blocks * 2 * C f32 scratch; counters: `tiles` zero unsigned ints, left
// zero; bits: NULL (the dx pass reads y), or with y and vec = 16 /
// sizeof(T) N * C / vec bytes of scratch for the mask. vec, cgt, tiles,
// blocks, rows_per, fvec: ops/fused_norm.colsum_vec_plan; dx_lanes,
// dx_blocks: ops/fused_norm.bn_dx_plan (same vec). Returns a cudaError_t
// (0 = launched).
extern "C" int bn_bwd(const void* x, const void* dy, const void* y,
                      const float* gamma, const float* mean,
                      const float* rstd, void* dx, float* sums, float* part,
                      unsigned* counters, uint8_t* bits, int64_t N, int C,
                      int vec, int cgt, int tiles, int blocks,
                      int64_t rows_per, int fvec, int64_t dx_lanes,
                      int dx_blocks, int dtype, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = run<T>(x, dy, y, gamma, mean, rstd, dx, sums, part,
                              counters, bits, N, C, vec, cgt, tiles, blocks,
                              rows_per, fvec, dx_lanes, dx_blocks, s));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* bn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
