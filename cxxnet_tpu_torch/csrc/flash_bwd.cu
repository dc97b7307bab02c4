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
// bit-equal. Any Sq and Sk, causal or not, and every even D up to 128.
//
// Bound on the H100, at the long-context LM's call (B 8, S 2048, H 8,
// D 16, bf16, causal): each kernel takes the B * H * S (S + 1) / 2 = 134 M
// exponentials once, 32 us at the SFU's 16 a clock per SM (132 SMs, 1.98
// GHz); its products (3 of 2 * 134 M * D FLOP for dQ, 4 for dK/dV, 13
// and 17 us at the bf16 tensor-core rate) and its bytes (5 and 6 MB,
// under 2 us) take less. At D = 16 the exponentials bound both.
//
// bf16 and f16 inputs (flash_bwd_dq_tc, flash_bwd_dkv_tc; flash_tc.cuh has
// the tile layout, shared with the forward): no online softmax is needed,
// lse is known, so per 16 x 16 block of scores a warp computes S and dP on
// the tensor cores, P = ex2(S * scale * log2(e) - lse * log2(e)) (one FFMA
// and the SFU a score; masks only on the tile that crosses the ragged edge
// or the warp's diagonal, a masked score -inf so that P is 0 whatever lse
// is) and dS = P (dP - delta), and feeds P and dS straight from the
// accumulators into the next products as hi + lo A fragments, both parts
// rounded to nearest: dS's row sums cancel to 0 and dV sums many small
// normalized P, so the forward's truncating split would bias both past
// the bound.
// - dQ: a CTA of 4 warps owns 64 query rows (a warp 16), longest causal
//   blocks first; Q's and dO's fragments, lse and delta of the warp's rows
//   stay in registers. It walks the key tiles of 64 up to the diagonal, K
//   and V through the cp.async ring: S = Q K^T and dP = dO V^T (K, V by
//   ldmatrix), then dQ += dS K (K by ldmatrix.trans); times scale at the
//   end.
// - dK/dV: a CTA of 4 warps owns 64 keys; K's and V's fragments stay in
//   registers. It walks the query tiles of 64 from the diagonal to Sq, Q,
//   dO and the tile's lse and delta (f32) through the ring: S^T = K Q^T
//   and dP^T = V dO^T, so P^T and dS^T come out with keys as rows and are
//   A fragments as they stand, then dV += P^T dO and dK += dS^T Q (Q, dO
//   by ldmatrix.trans).
// f16: P enters as P * 2^14 (P <= 1) and dS's lo part as 2^11 times the
// remainder, each scaled back exactly, so neither part falls into f16's
// subnormals. Outputs go through shared memory in 16-byte stores.
//
// f32 inputs (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the CUDA-core
// kernels (flash.cuh has their thread layout): a CTA owns 64 rows held by
// DMAX / 16 threads each and stages the other operands' tiles as f32.
// - dQ: a thread holds q_i, dO_i, lse_i, delta_i and its share of dq, and
//   walks the key tiles up to the diagonal.
// - dK/dV: a thread holds k_j, v_j and both accumulators, and walks the
//   query tiles from the diagonal down, with their lse and delta.
#include "flash.cuh"
#include "flash_tc.cuh"

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

namespace tc {

// a stage of the dK/dV kernel: a Q and a dO tile, then the tile's lse and
// delta as f32
template <typename T, int DMAX>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 2 * kBK * pitch<DMAX>() * (int)sizeof(T) + 2 * kBK * 4;
}
// the dK/dV kernel holds K's and V's A fragments in registers up to
// DMAX 64. At 128 they would take 64 of a thread's 255 beside the two
// 16 x 128 accumulators: K and V stay staged after a ring of two stages
// (two CTAs an SM) and their fragments are loaded for each use.
template <int DMAX> __host__ __device__ constexpr bool kv_in_regs() {
  return DMAX <= 64;
}
template <int DMAX> __host__ __device__ constexpr int dkv_stages() {
  return kv_in_regs<DMAX>() ? kStages : 2;
}
template <typename T, int DMAX>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return dkv_stages<DMAX>() * dkv_stage_bytes<T, DMAX>() +
         (kv_in_regs<DMAX>() ? 0 : 2 * kRows * pitch<DMAX>() * (int)sizeof(T));
}
// P's factor on its way into dV's product (P <= 1): f16 lifts it out of
// the subnormals, bf16 needs nothing
template <typename T> __host__ __device__ constexpr float p_lift();
template <> __host__ __device__ constexpr float p_lift<__nv_bfloat16>() {
  return 1.f;
}
template <> __host__ __device__ constexpr float p_lift<__half>() {
  return 16384.f;
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int D, float scale, float scale_log2,
                int causal) {
  constexpr int P = pitch<DMAX>(), TILE = kBK * P;
  constexpr int KD = DMAX / 16;   // k16 steps of Q K^T
  constexpr int NO = DMAX / 8;    // n8 blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);   // stage s: K, then V
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int qw = q0 + warp * 16;   // the warp's first row
  const int64_t rs = (int64_t)H * D;
  const int64_t base = (int64_t)h * D;
  const T* kb = k + (int64_t)b * Sk * rs + base;
  const T* vb = v + (int64_t)b * Sk * rs + base;
  const int64_t qo = (int64_t)b * Sq * rs + base;   // row 0 of q, dO, dq

  // causal: key tiles starting past the CTA's last query row are skipped
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int ntiles = (k_end + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) {
      load_tile<T, DMAX, VEC>(sm + t * 2 * TILE, kb, rs, t * kBK, Sk, D);
      load_tile<T, DMAX, VEC>(sm + t * 2 * TILE + TILE, vb, rs, t * kBK, Sk,
                              D);
    }
    ptx::cp_async_commit();
  }

  unsigned qf[KD][4], df[KD][4];   // Q's and dO's A fragments, once
  load_a<T, KD>(qf, q + qo, rs, qw, Sq, D);
  load_a<T, KD>(df, dout + qo, rs, qw, Sq, D);
  // rows gid (0) and gid + 8 (1): -lse in log2 units, and delta
  float nl[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + gid + i * 8;
    nl[i] = row < Sq ? -lse[(int64_t)bh * Sq + row] * kLog2e : 0.f;
    dl[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    ptx::cp_async_wait<kStages - 2>();   // tile t has landed for this thread
    // ... and for every thread; and every warp is done with tile t - 1,
    // whose stage tile t + kStages - 1 takes
    __syncthreads();
    if (t + kStages - 1 < ntiles) {
      const int tn = t + kStages - 1;
      T* nxt = sm + (tn % kStages) * 2 * TILE;
      load_tile<T, DMAX, VEC>(nxt, kb, rs, tn * kBK, Sk, D);
      load_tile<T, DMAX, VEC>(nxt + TILE, vb, rs, tn * kBK, Sk, D);
    }
    ptx::cp_async_commit();
    const T* ks = sm + (t % kStages) * 2 * TILE;
    const T* vs = ks + TILE;
    const int k0 = t * kBK;
    // the tile crosses the ragged key edge or, causal, the warp's diagonal
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > qw);

    // 16 keys at a time: S and dP as two n8 blocks each, then dS in place
    // of S, then dQ += dS K
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      float s[2][4] = {}, dp[2][4] = {};
      mma_rows<T, KD, P>(s[0], s[1], qf, ks + kc * 16 * P);
      mma_rows<T, KD, P>(dp[0], dp[1], df, vs + kc * 16 * P);
      if (edge) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int key = k0 + kc * 16 + jj * 8 + tig * 2 + (r & 1);
            const int row = qw + gid + (r >> 1) * 8;
            if (key >= Sk || (causal && key > row)) s[jj][r] = -INFINITY;
          }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = ptx::ex2(fmaf(s[jj][r], scale_log2, nl[r >> 1]));
          s[jj][r] = p * (dp[jj][r] - dl[r >> 1]);
        }
      unsigned hi[4], lo[4];
      to_a<T, lo_shift<T>()>(s[0], s[1], hi, lo);
      mma_hilo<T, NO, P, lo_shift<T>()>(acc, hi, lo, ks + kc * 16 * P);
    }
  }

#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] *= scale;
  // the warp's rows staged in a stage no warp reads any more (the last
  // tile's is (ntiles - 1) % kStages)
  store_rows<T, DMAX, VEC>(dq + qo, rs, qw, Sq, D, acc,
                           sm + (ntiles % kStages) * 2 * TILE + warp * 16 * P);
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int H, int D,
                 float scale, float scale_log2, int causal) {
  constexpr int P = pitch<DMAX>(), TILE = kBK * P;
  constexpr int KD = DMAX / 16;   // k16 steps of K Q^T
  constexpr int NO = DMAX / 8;    // n8 blocks of dK and dV
  constexpr int STAGE = dkv_stage_bytes<T, DMAX>();
  constexpr int SHIFT = lo_shift<T>();
  constexpr float LIFT = p_lift<T>();
  constexpr bool KV_REGS = kv_in_regs<DMAX>();
  constexpr int NST = dkv_stages<DMAX>();
  // stage s at smem_raw + s * STAGE: the Q tile, the dO tile (T), then
  // the tile's lse and delta (f32); past the ring, unless KV_REGS, the
  // CTA's K and V rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kvs = reinterpret_cast<T*>(smem_raw + NST * STAGE);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows;   // causal: the longest come first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kw = k0 + warp * 16;   // the warp's first key
  const int64_t rs = (int64_t)H * D;
  const int64_t base = (int64_t)h * D;
  const T* qb = q + (int64_t)b * Sq * rs + base;
  const T* db = dout + (int64_t)b * Sq * rs + base;
  const float* lb = lse + (int64_t)bh * Sq;
  const float* dlb = delta + (int64_t)bh * Sq;
  const int64_t ko = (int64_t)b * Sk * rs + base;   // row 0 of k, v, dk, dv

  // causal: query tiles wholly before the CTA's first key are skipped
  const int q_start = causal ? k0 : 0;
  const int ntiles = q_start < Sq ? (Sq - q_start + kBK - 1) / kBK : 0;
  // tile t (queries from q_start + t kBK) into stage t % NST; lse and
  // delta one f32 a thread (kThreads = 2 kBK)
  auto load = [&](int t) {
    unsigned char* st = smem_raw + (t % NST) * STAGE;
    const int r0 = q_start + t * kBK;
    load_tile<T, DMAX, VEC>(reinterpret_cast<T*>(st), qb, rs, r0, Sq, D);
    load_tile<T, DMAX, VEC>(reinterpret_cast<T*>(st) + TILE, db, rs, r0, Sq,
                            D);
    const int i = threadIdx.x % kBK;
    const float* src = threadIdx.x < kBK ? lb : dlb;
    const bool ok = r0 + i < Sq;
    ptx::cp_async4(reinterpret_cast<float*>(st + 2 * TILE * sizeof(T)) +
                       threadIdx.x,
                   ok ? src + r0 + i : src, ok);
  };
  if (!KV_REGS) {   // with tile 0's copies
    load_tile<T, DMAX, VEC>(kvs, k + ko, rs, k0, Sk, D);
    load_tile<T, DMAX, VEC>(kvs + TILE, v + ko, rs, k0, Sk, D);
  }
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < ntiles) load(t);
    ptx::cp_async_commit();
  }

  unsigned kf[KD][4], vf[KD][4];   // K's and V's A fragments
  if (KV_REGS) {                   // once
    load_a<T, KD>(kf, k + ko, rs, kw, Sk, D);
    load_a<T, KD>(vf, v + ko, rs, kw, Sk, D);
  }

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[nb][r] = dva[nb][r] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    ptx::cp_async_wait<NST - 2>();   // tile t has landed for this thread
    // ... and for every thread; and every warp is done with tile t - 1,
    // whose stage tile t + NST - 1 takes
    __syncthreads();
    if (t + NST - 1 < ntiles) load(t + NST - 1);
    ptx::cp_async_commit();
    const T* qs = reinterpret_cast<const T*>(smem_raw + (t % NST) * STAGE);
    const T* ds = qs + TILE;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * TILE);
    const int qt = q_start + t * kBK;
    // the tile crosses the ragged query edge or, causal, the warp's
    // diagonal
    const bool edge = qt + kBK > Sq || (causal && qt < kw + 16);

    // 16 queries at a time: S^T and dP^T as two n8 blocks each (keys as
    // rows), then P^T and dS^T, then dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int qc = 0; qc < kBK / 16; ++qc) {
      float s[2][4] = {}, dp[2][4] = {};
      if (!KV_REGS) ldmatrix_a<T, KD, P>(kf, kvs + warp * 16 * P);
      mma_rows<T, KD, P>(s[0], s[1], kf, qs + qc * 16 * P);
      if (!KV_REGS) ldmatrix_a<T, KD, P>(vf, kvs + TILE + warp * 16 * P);
      mma_rows<T, KD, P>(dp[0], dp[1], vf, ds + qc * 16 * P);
      if (edge) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qi = qt + qc * 16 + jj * 8 + tig * 2 + (r & 1);
            const int key = kw + gid + (r >> 1) * 8;
            if (qi >= Sq || (causal && key > qi)) s[jj][r] = -INFINITY;
          }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        // the columns' lse (log2 units, negated) and delta
        const int c = qc * 16 + jj * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + kBK + c);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = ptx::ex2(fmaf(s[jj][r], scale_log2, nl[r & 1]));
          dp[jj][r] = p * (dp[jj][r] - dl[r & 1]);   // dS^T
          s[jj][r] = LIFT == 1.f ? p : p * LIFT;    // P^T
        }
      }
      unsigned hi[4], lo[4];
      to_a<T, 0>(s[0], s[1], hi, lo);
      mma_hilo<T, NO, P, 0>(dva, hi, lo, ds + qc * 16 * P);
      to_a<T, SHIFT>(dp[0], dp[1], hi, lo);
      mma_hilo<T, NO, P, SHIFT>(dka, hi, lo, qs + qc * 16 * P);
    }
  }

#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dka[nb][r] *= scale;
      dva[nb][r] *= 1.f / LIFT;
    }
  ptx::cp_async_wait<0>();   // K's and V's copies too, when no tile ran
  // the warp's rows staged in a stage no warp reads any more (the last
  // tile's is (ntiles - 1) % NST): dK where Q was, dV where dO was
  T* so = reinterpret_cast<T*>(smem_raw + (ntiles % NST) * STAGE) +
          warp * 16 * P;
  store_rows<T, DMAX, VEC>(dk + ko, rs, kw, Sk, D, dka, so);
  store_rows<T, DMAX, VEC>(dv + ko, rs, kw, Sk, D, dva, so + TILE);
}

template <typename T, int DMAX, bool VEC>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Sk, int H, int D, float scale, int causal,
              cudaStream_t st) {
  constexpr int bytes = kv_ring_bytes<T, DMAX>();
  const cudaError_t e = allow_smem(flash_bwd_dq_tc<T, DMAX, VEC>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_bwd_dq_tc<T, DMAX, VEC><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Sq, Sk, H, D, scale, exp2_factor(scale), causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX, bool VEC>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Sq, int Sk, int H, int D, float scale, int causal,
               cudaStream_t st) {
  constexpr int bytes = dkv_smem_bytes<T, DMAX>();
  const cudaError_t e = allow_smem(flash_bwd_dkv_tc<T, DMAX, VEC>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sk + kRows - 1) / kRows);
  flash_bwd_dkv_tc<T, DMAX, VEC><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Sq, Sk, H, D, scale, exp2_factor(scale), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int B,
                int Sq, int Sk, int H, int D, float scale, int causal,
                cudaStream_t st) {
  const int vec = vec_mode(D, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                  (uintptr_t)dout | (uintptr_t)dq);
  if (vec < 0) return (int)cudaErrorMisalignedAddress;
  if (vec) {
    FLASH_DMAX(D, return launch_dq<T, DMAX, true>(q, k, v, dout, lse, delta,
                                                   dq, B, Sq, Sk, H, D, scale,
                                                   causal, st))
  } else {
    FLASH_DMAX(D, return launch_dq<T, DMAX, false>(q, k, v, dout, lse, delta,
                                                    dq, B, Sq, Sk, H, D,
                                                    scale, causal, st))
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                 float scale, int causal, cudaStream_t st) {
  const int vec = vec_mode(D, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                  (uintptr_t)dout | (uintptr_t)dk |
                                  (uintptr_t)dv);
  if (vec < 0) return (int)cudaErrorMisalignedAddress;
  if (vec) {
    FLASH_DMAX(D, return launch_dkv<T, DMAX, true>(q, k, v, dout, lse, delta,
                                                    dk, dv, B, Sq, Sk, H, D,
                                                    scale, causal, st))
  } else {
    FLASH_DMAX(D, return launch_dkv<T, DMAX, false>(q, k, v, dout, lse,
                                                     delta, dk, dv, B, Sq, Sk,
                                                     H, D, scale, causal, st))
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// q and dout (B, Sq, H, D), k and v (B, Sk, H, D), dq like q, all of one
// dtype (code of common.cuh), contiguous; lse and delta (B, H, Sq) f32.
// bf16 and f16 run on the tensor cores, f32 on the CUDA cores. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int Sq,
                            int Sk, int H, int D, float scale, int causal,
                            int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return tc::dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B,
                                            Sq, Sk, H, D, scale, causal, st);
    case kF16:
      return tc::dispatch_dq<__half>(q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                     H, D, scale, causal, st);
    case kF32: {
      typedef float T;
      const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
      FLASH_DMAX(D,
          flash_bwd_dq_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0,
                                         st>>>(
              (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
              delta, (T*)dq, Sq, Sk, H, D, scale, causal))
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// as flash_bwd_dq, writing dk and dv like k
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return tc::dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk,
                                             dv, B, Sq, Sk, H, D, scale,
                                             causal, st);
    case kF16:
      return tc::dispatch_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, B,
                                      Sq, Sk, H, D, scale, causal, st);
    case kF32: {
      typedef float T;
      const dim3 grid(B * H, (Sk + kRows - 1) / kRows);
      FLASH_DMAX(D,
          flash_bwd_dkv_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0,
                                          st>>>(
              (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse,
              delta, (T*)dk, (T*)dv, Sq, Sk, H, D, scale, causal))
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
