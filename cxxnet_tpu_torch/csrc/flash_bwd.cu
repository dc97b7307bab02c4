// Flash-attention backward: dQ in one kernel, dK and dV in another, both
// rebuilding the softmax from the forward's logsumexp.
//
// Replaces the TPU kernels cxxnet_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (pallas_call at attention.py:490) and _flash_bwd_dkv_kernel (:505), from
// _flash_backward. Same functions, in f32 whatever the input type, over the
// pairs (i, j) that count (all, or j <= i when causal):
//   p_ij  = exp(scale * q_i . k_j - lse_i)
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale,  delta_i = dO_i . o_i
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i
// each written in the input type. delta is the plain torch reduction the
// wrapper makes beforehand, as the JAX package computes it outside Pallas.
// Two kernels, as on the TPU, so that no atomics are needed and reruns are
// bit-equal. Any S and every even D up to 128.
//
// Bound on the H100: for the long-context LM's call (B 8, S 2048, H 8,
// D 16, bf16, causal) the dQ kernel does 3 products of 2 * B * H * S^2 *
// D / 2 FLOP (s, dO.v and ds.k) = 12.9 GFLOP, the dK/dV kernel 4 products
// = 17.2 GFLOP: 13 and 17 us at the bf16 tensor-core rate (989 TFLOP/s),
// 0.19 and 0.26 ms on the f32 CUDA cores (67 TFLOP/s) where these kernels
// compute. Their bytes (5 and 6 MB) take under 2 us.
//
// Design (flash.cuh has the thread layout): the TPU grid's sequential axis
// becomes a loop inside the CTA.
// - dQ: a CTA owns 64 query rows of one (batch, head), holds q_i, dO_i,
//   lse_i, delta_i and the dq accumulator in registers, and walks the key
//   tiles up to the diagonal, each tile of K and V staged in shared memory.
// - dK/dV: a CTA owns 64 key rows, holds k_j, v_j and both accumulators in
//   registers, and walks the query tiles from the diagonal down, each tile
//   of Q and dO staged in shared memory with its lse and delta.
// No tensor cores yet: simple kernels that are right first.
#include "flash.cuh"

using namespace flash;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows * (DMAX / kSlice))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int D, float scale, int causal) {
  constexpr int TPR = DMAX / kSlice;
  constexpr int BK = Tile<DMAX>::kRowsStaged;
  __shared__ float ks[BK][DMAX];
  __shared__ float vs[BK][DMAX];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool valid = qi < Sq;
  const int64_t rs = (int64_t)H * D;
  const T* kb = k + (int64_t)b * Sk * rs + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Sk * rs + (int64_t)h * D;
  const int64_t qrow = ((int64_t)b * Sq + qi) * rs + (int64_t)h * D;

  float qr[kSlice], dor[kSlice], acc[kSlice];
  load_part(qr, q + qrow, part, D, valid);
  load_part(dor, dout + qrow, part, D, valid);
#pragma unroll
  for (int t = 0; t < kSlice; ++t) acc[t] = 0.f;
  const float L = valid ? lse[(int64_t)bh * Sq + qi] : 0.f;
  const float dl = valid ? delta[(int64_t)bh * Sq + qi] : 0.f;

  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<T, DMAX, BK>(ks, kb, rs, k0, Sk, D);
    stage<T, DMAX, BK>(vs, vb, rs, k0, Sk, D);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float* kr = &ks[j][part * kSlice];
      const float s = row_sum<TPR>(part_dot(qr, kr)) * scale;
      const float dp = row_sum<TPR>(part_dot(dor, &vs[j][part * kSlice]));
      const float p = keep(qi, k0 + j, Sq, Sk, causal) ? expf(s - L) : 0.f;
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int t = 0; t < kSlice; ++t) acc[t] = fmaf(ds, kr[t], acc[t]);
    }
  }
  if (valid) store_part(dq + qrow, acc, part, D);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows * (DMAX / kSlice))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int D,
                     float scale, int causal) {
  constexpr int TPR = DMAX / kSlice;
  constexpr int BQ = Tile<DMAX>::kRowsStaged;
  __shared__ float qs[BQ][DMAX];
  __shared__ float dos[BQ][DMAX];
  __shared__ float ls[BQ];
  __shared__ float dls[BQ];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int kj = k0 + row;
  const bool valid = kj < Sk;
  const int64_t rs = (int64_t)H * D;
  const T* qb = q + (int64_t)b * Sq * rs + (int64_t)h * D;
  const T* db = dout + (int64_t)b * Sq * rs + (int64_t)h * D;
  const int64_t krow = ((int64_t)b * Sk + kj) * rs + (int64_t)h * D;
  const float* lb = lse + (int64_t)bh * Sq;
  const float* dlb = delta + (int64_t)bh * Sq;

  float kr[kSlice], vr[kSlice], dka[kSlice], dva[kSlice];
  load_part(kr, k + krow, part, D, valid);
  load_part(vr, v + krow, part, D, valid);
#pragma unroll
  for (int t = 0; t < kSlice; ++t) dka[t] = dva[t] = 0.f;

  // causal: query tiles wholly before the CTA's first key are skipped
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int qt = q_start; qt < Sq; qt += BQ) {
    __syncthreads();
    stage<T, DMAX, BQ>(qs, qb, rs, qt, Sq, D);
    stage<T, DMAX, BQ>(dos, db, rs, qt, Sq, D);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      ls[i] = qt + i < Sq ? lb[qt + i] : 0.f;
      dls[i] = qt + i < Sq ? dlb[qt + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < BQ; ++i) {
      const float* qrow = &qs[i][part * kSlice];
      const float* drow = &dos[i][part * kSlice];
      const float s = row_sum<TPR>(part_dot(kr, qrow)) * scale;
      const float dp = row_sum<TPR>(part_dot(vr, drow));
      const float p = keep(qt + i, kj, Sq, Sk, causal) ? expf(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
      for (int t = 0; t < kSlice; ++t) {
        dva[t] = fmaf(p, drow[t], dva[t]);
        dka[t] = fmaf(ds, qrow[t], dka[t]);
      }
    }
  }
  if (valid) {
    store_part(dk + krow, dka, part, D);
    store_part(dv + krow, dva, part, D);
  }
}

// q and dout (B, Sq, H, D), k and v (B, Sk, H, D), dq like q, all of one
// dtype (code of common.cuh), contiguous; lse and delta (B, H, Sq) f32.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int Sq,
                            int Sk, int H, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dtype, D,
      flash_bwd_dq_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
          (T*)dq, Sq, Sk, H, D, scale, causal))
  return (int)cudaGetLastError();
}

// as flash_bwd_dq, writing dk and dv like k
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sk + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dtype, D,
      flash_bwd_dkv_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
          (T*)dk, (T*)dv, Sq, Sk, H, D, scale, causal))
  return (int)cudaGetLastError();
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
