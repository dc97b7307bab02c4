// Synchronized (cross-rank) batch norm with an optional folded relu, over
// (N, C) rows: the four per-rank passes around the two all-reduces.
//
// Replaces the TPU kernels of the dp-mesh island in
// cxxnet_tpu/ops/fused_norm.py (pallas_calls in _mesh_fwd_local and
// _mesh_bwd_local):
//   bn_sums      <- _bn_sums_kernel:     S1 = sum x, S2 = sum x^2 (f32)
//   bn_norm      <- _bn_norm_kernel:     y = (x - mean) * rstd * gamma + beta
//                                        (+ relu), y in the dtype of x
//   bn_bwd_sums  <- _bn_bwd_sums_kernel: SB = sum dy', SXH = sum dy' * x_hat
//   bn_bwd_dx    <- _bn_bwd_dx_kernel:   dx = gamma * rstd *
//                                        (dy' - SB/N - x_hat * SXH/N)
// with dy' = dy masked by y > 0 when the relu was folded in and
// x_hat = (x - mean) * rstd. The sums are the rank's own; the caller
// all-reduces them and hands the global mean, rstd and SB/N, SXH/N back
// in as (C,) f32 vectors, as the TPU island's psum did.
//
// Bound on the H100 (3.35 TB/s): the bytes that must move. bn_sums reads x
// once (N * C * sizeof(T)); bn_norm reads x and writes y (2x); bn_bwd_sums
// reads x, dy and, with relu, y (3x); bn_bwd_dx reads those and writes dx
// (4x). Operations are a handful per element, far below the f32 rate.
//
// Design: bn_sums is one launch of colsum_vec.cuh's vectorised column
// sums with bn_moments.cuh's MomentsVec op (16-byte loads of x, the last
// CTA of a channel tile adds the row blocks' partials in a fixed order),
// the launch bn_fwd (bn_fwd.cu) takes for its one-pass moments, so the two
// agree bit for bit on the same rows. bn_bwd_sums and bn_bwd_dx are the
// two passes of bn_bwd_vec.cuh, which bn_bwd (bn_bwd.cu) launches back to
// back on one device's rows: the same column sums with the BwdSumsVec op,
// and the vectorised dx pass (a thread keeps its 16 bytes of channels and
// their constants for its whole loop, SB/N and SXH/N handed in). The sums
// add in a fixed order, so two runs on the same input agree bit for bit
// and so do both ranks' reductions of the same rows. They write into one
// (2, C) f32 buffer, the buffer the caller all-reduces in one call.
// bn_norm is bn_norm_vec.cuh's walk, the dx pass's: a thread keeps its 16
// bytes of channels and their mean, rstd, gamma and beta in registers,
// 16-byte loads of x and stores of y. Every multiply and add is a rounded
// f32 operation in the order of the plain PyTorch version (no contraction
// into an FMA), so bn_norm is bit-equal to its plain version on finite
// inputs. Any N and C: the TPU kernel's row-block divisibility does not
// apply. At bn_stem1 per rank on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py --ab) bn_bwd_dx takes 0.1373 ms, 1.12x its bound (a
// scalar grid-stride loop took 0.1903; torch.batch_norm_backward_elemt
// 0.1538, reading no mask); bn_norm 0.0763 ms, 1.24x its bound (the
// scalar grid-stride loop it replaced 0.1425, torch.batch_norm_elemt
// 0.1285 without the relu); bn_sums 0.0418 ms, 1.36x its bound (the
// two-stage scalar column sum it replaced 0.0740 in the same call,
// torch.batch_norm_stats 0.187).
#include "bn_bwd_vec.cuh"
#include "bn_moments.cuh"
#include "bn_norm_vec.cuh"

// x: (N, C) of dtype code `dtype`; sums: (2, C) f32 output, row 0 S1 and
// row 1 S2; part: blocks * 2 * C f32 scratch; counters: `tiles` zero
// unsigned ints, left zero. vec, cgt, tiles, blocks, rows_per, fvec:
// ops/fused_norm.colsum_vec_plan. Returns a cudaError_t.
extern "C" int bn_sums(const void* x, float* sums, float* part,
                       unsigned* counters, int64_t N, int C, int vec,
                       int cgt, int tiles, int blocks, int64_t rows_per,
                       int fvec, int dtype, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (launch_moments<T>(x, sums, part, counters, N, C,
                                          vec, cgt, tiles, blocks, rows_per,
                                          fvec, kSumsX2, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x, y: (N, C) of dtype code `dtype`; gamma, beta, mean, rstd: (C,) f32.
// vec, lanes, blocks: ops/fused_norm.bn_dx_plan. Returns a cudaError_t.
extern "C" int bn_norm(const void* x, const float* gamma, const float* beta,
                       const float* mean, const float* rstd, void* y,
                       int64_t N, int C, int vec, int64_t lanes, int blocks,
                       int dtype, int relu, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (launch_bn_norm<T>(x, gamma, beta, mean, rstd, y, N,
                                          C, vec, lanes, blocks, relu, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x, dy: (N, C) of dtype code `dtype`; y: the forward's output when the
// relu was folded in, else NULL; mean, rstd: (C,) f32; sums: (2, C) f32
// output, row 0 SB and row 1 SXH; part: blocks * 2 * C f32 scratch;
// counters: `tiles` zero unsigned ints, left zero. vec, cgt, tiles,
// blocks, rows_per, fvec: ops/fused_norm.colsum_vec_plan. Returns a
// cudaError_t.
extern "C" int bn_bwd_sums(const void* x, const void* dy, const void* y,
                           const float* mean, const float* rstd, float* sums,
                           float* part, unsigned* counters, int64_t N, int C,
                           int vec, int cgt, int tiles, int blocks,
                           int64_t rows_per, int fvec, int dtype,
                           void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (launch_bwd_sums<T>(
                      x, dy, y, nullptr, mean, rstd, sums, part, counters,
                      N, C, vec, cgt, tiles, blocks, rows_per, fvec, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x, dy, dx: (N, C) of dtype code `dtype`; y as for bn_bwd_sums; gamma,
// mean, rstd and the global SB / N_global (sbn) and SXH / N_global (sxhn):
// (C,) f32. vec, lanes, blocks: ops/fused_norm.bn_dx_plan. Returns a
// cudaError_t.
extern "C" int bn_bwd_dx(const void* x, const void* dy, const void* y,
                         const float* gamma, const float* mean,
                         const float* rstd, const float* sbn,
                         const float* sxhn, void* dx, int64_t N, int C,
                         int vec, int64_t lanes, int blocks, int dtype,
                         void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (launch_bn_dx<T>(
                      x, dy, y, nullptr, gamma, mean, rstd, sbn, sxhn, 0.f,
                      dx, N, C, vec, lanes, blocks, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* bn_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_bwd_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_bwd_dx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
