// Flash-attention forward: softmax(scale * Q K^T) V with the per-row
// logsumexp, online over key tiles, causal or not.
//
// Replaces the TPU kernel cxxnet_tpu/ops/attention.py:_flash_fwd_kernel
// (pallas_call in _flash_forward, attention.py:334). Same function: per
// (batch, head) and query row i, over the keys j that count (all, or
// j <= i when causal), in f32 whatever the input type:
//   s_ij = scale * q_i . k_j;  m_i = max_j s_ij;  l_i = sum_j exp(s_ij - m_i)
//   o_i = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)    (in the input type)
//   lse_i = m_i + log(max(l_i, 1e-30))                     (f32)
// with the TPU kernel's running max starting at -1e30, so a row with no
// key gives zeros. Unlike the TPU kernel, any S works (the ragged last
// tile is masked) and the tiles are this card's, not the config's
// attn_block.
//
// Bound on the H100, at the long-context LM's call (B 8, S 2048, H 8,
// D 16, bf16, causal): the products are 4 * B * H * S^2 * D / 2 = 8.6
// GFLOP, 8.7 us at the bf16 tensor-core rate (989 TFLOP/s); the
// B * H * S (S + 1) / 2 = 134 M exponentials take 32 us at the SFU's 16
// a clock per SM (132 SMs, 1.98 GHz); the bytes (4 MB) 1.3 us. At D = 16
// the exponentials bound it.
//
// bf16 and f16 inputs (flash_fwd_tc; flash_tc.cuh has the pieces it shares
// with the backward kernels): a CTA of 4 warps owns 64 query rows
// of one (batch, head), a warp 16 of them, and walks the key tiles of 64
// up to the diagonal (the TPU grid's sequential k-block axis as a loop).
// K and V tiles stay in the input type in shared memory, in a ring of
// three stages: the next two tiles' 16-byte cp.async copies are in flight
// while the current one is computed, one barrier a tile; the copies
// zero-fill the ragged last tile and the features past D. S = Q K^T runs on the tensor cores (mma.sync m16n8k16,
// f32 accumulators; Q's fragments loaded once from global memory, K's by
// ldmatrix). The online softmax works on the accumulator fragments: a
// row's max and sum take two shuffles within its quad, scale * log2(e) is
// folded into one FFMA per score and exp2 is the SFU's ex2.approx; masks
// are applied only on the tile that crosses the ragged key edge or the
// warp's diagonal. P stays in registers as the A operand of P V (V by
// ldmatrix.trans), split into a hi and a lo part in the input type so the
// product sees P to about 2^-16 (the plain version keeps P in f32), at the
// cost of a second product, small next to the exponentials at D = 16.
// The longest causal query blocks are scheduled first. The output tile is
// staged in shared memory and stored in 16-byte vectors; lse in natural
// log.
//
// f32 inputs (flash_fwd_kernel): the CUDA-core kernel; flash.cuh has its
// thread layout. A row is held by DMAX / 16 threads; each tile of K and V
// is staged as f32, each thread computes its row's logits for the whole
// tile, takes the tile's max, rescales once and adds exp(s - m) v_j.
#include "flash.cuh"
#include "flash_tc.cuh"

using namespace flash;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows * (DMAX / kSlice))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int D,
                 float scale, int causal) {
  constexpr int TPR = DMAX / kSlice;
  constexpr int BK = Tile<DMAX>::kRowsStaged;
  __shared__ float ks[BK][DMAX];
  __shared__ float vs[BK][DMAX];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const int64_t rs = (int64_t)H * D;
  const T* kb = k + (int64_t)b * Sk * rs + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Sk * rs + (int64_t)h * D;
  const int64_t qrow = ((int64_t)b * Sq + qi) * rs + (int64_t)h * D;

  float qr[kSlice], acc[kSlice];
  load_part(qr, q + qrow, part, D, qi < Sq);
#pragma unroll
  for (int t = 0; t < kSlice; ++t) acc[t] = 0.f;
  float m = kNeg, l = 0.f;

  // causal: key tiles starting past the CTA's last query row are skipped
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<T, DMAX, BK>(ks, kb, rs, k0, Sk, D);
    stage<T, DMAX, BK>(vs, vb, rs, k0, Sk, D);
    __syncthreads();
    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float dot = row_sum<TPR>(part_dot(qr, &ks[j][part * kSlice]));
      s[j] = keep(qi, k0 + j, Sq, Sk, causal) ? dot * scale : kNeg;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kSlice; ++t) acc[t] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = keep(qi, k0 + j, Sq, Sk, causal) ? expf(s[j] - mt) : 0.f;
      psum += p;
      const float* vr = &vs[j][part * kSlice];
#pragma unroll
      for (int t = 0; t < kSlice; ++t) acc[t] = fmaf(p, vr[t], acc[t]);
    }
    l = l * corr + psum;
    m = mt;
  }
  if (qi < Sq) {
    const float lf = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < kSlice; ++t) acc[t] = acc[t] / lf;
    store_part(o + qrow, acc, part, D);
    if (part == 0) lse[(int64_t)bh * Sq + qi] = m + logf(lf);
  }
}

namespace tc {

constexpr int kNJ = kBK / 8;             // n8 blocks of a tile's S

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int D,
             float scale_log2, int causal) {
  constexpr int P = pitch<DMAX>(), TILE = kBK * P;
  constexpr int KD = DMAX / 16;   // k16 steps of Q K^T
  constexpr int NO = DMAX / 8;    // n8 blocks of the output
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
  const int64_t qo = (int64_t)b * Sq * rs + base;   // row 0 of q and o

  // causal: key tiles starting past the CTA's last query row are skipped
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int ntiles = (k_end + kBK - 1) / kBK;
  // tile t goes to stage t % kStages; tiles 0 .. kStages - 2 up front
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) {
      load_tile<T, DMAX, VEC>(sm + t * 2 * TILE, kb, rs, t * kBK, Sk, D);
      load_tile<T, DMAX, VEC>(sm + t * 2 * TILE + TILE, vb, rs, t * kBK, Sk,
                              D);
    }
    ptx::cp_async_commit();
  }

  unsigned qf[KD][4];   // Q's A fragments, once
  load_a<T, KD>(qf, q + qo, rs, qw, Sq, D);

  float oacc[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) oacc[nb][r] = 0.f;
  // rows gid (0) and gid + 8 (1): running max (log2 units), and this
  // thread's share of the running sum
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

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

    // S = Q K^T: kNJ n8 blocks of keys
    float s[kNJ][4];
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int jn = 0; jn < kNJ / 2; ++jn)
      mma_rows<T, KD, P>(s[2 * jn], s[2 * jn + 1], qf, ks + jn * 16 * P);
    // masks where the tile crosses the ragged key edge or, causal, the
    // warp's diagonal; a masked logit is -inf, so its exp2 is 0
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > qw)) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + j * 8 + tig * 2 + (r & 1);
          const int row = qw + gid + (r >> 1) * 8;
          if (key >= Sk || (causal && key > row)) s[j][r] = -INFINITY;
        }
    }

    // online softmax on the fragments
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i] * scale_log2);
      const float corr = ptx::ex2(m[i] - mn);
      m[i] = mn;
      neg_m[i] = -mn;
      l[i] *= corr;
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) {
        oacc[nb][2 * i] *= corr;
        oacc[nb][2 * i + 1] *= corr;
      }
    }

    // P V, 16 keys at a time: P's A fragments from the S accumulators of
    // key blocks 2 kc and 2 kc + 1, in a hi and a lo part
#pragma unroll
    for (int kc = 0; kc < kNJ / 2; ++kc) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[jj][r] = ptx::ex2(fmaf(s[2 * kc + jj][r], scale_log2,
                                   neg_m[r >> 1]));
          l[r >> 1] += p[jj][r];
        }
      unsigned ahi[4], alo[4];
      to_a<T, kCut>(p[0], p[1], ahi, alo);
      mma_hilo<T, NO, P, 0>(oacc, ahi, alo, vs + kc * 16 * P);
    }
  }

  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lf[i] = fmaxf(l[i], 1e-30f);
    const int row = qw + gid + i * 8;
    if (tig == 0 && row < Sq)
      lse[(int64_t)bh * Sq + row] =
          (m[i] == kNeg ? kNeg : m[i] * kLn2) + logf(lf[i]);
  }
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) oacc[nb][r] = oacc[nb][r] / lf[r >> 1];
  // the warp's rows staged in a stage no warp reads any more (the last
  // tile's is (ntiles - 1) % kStages)
  store_rows<T, DMAX, VEC>(o + qo, rs, qw, Sq, D, oacc,
                           sm + (ntiles % kStages) * 2 * TILE + warp * 16 * P);
}

template <typename T, int DMAX, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int D, float scale, int causal,
           cudaStream_t st) {
  constexpr int bytes = kv_ring_bytes<T, DMAX>();
  const cudaError_t e = allow_smem(flash_fwd_tc<T, DMAX, VEC>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_fwd_tc<T, DMAX, VEC><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, D,
      exp2_factor(scale), causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Sk, int H, int D, float scale,
             int causal, cudaStream_t st) {
  const int vec = vec_mode(D, (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                  (uintptr_t)o);
  if (vec < 0) return (int)cudaErrorMisalignedAddress;
  if (vec) {
    FLASH_DMAX(D, return launch<T, DMAX, true>(q, k, v, o, lse, B, Sq, Sk,
                                                H, D, scale, causal, st))
  } else {
    FLASH_DMAX(D, return launch<T, DMAX, false>(q, k, v, o, lse, B, Sq, Sk,
                                                 H, D, scale, causal, st))
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// q (B, Sq, H, D), k and v (B, Sk, H, D), o like q, all of one dtype
// (code of common.cuh), contiguous; lse (B, H, Sq) f32. bf16 and f16 run
// on the tensor cores, f32 on the CUDA cores. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int D,
                         float scale, int causal, int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return tc::dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, D,
                                         scale, causal, st);
    case kF16:
      return tc::dispatch<__half>(q, k, v, o, lse, B, Sq, Sk, H, D, scale,
                                  causal, st);
    case kF32: {
      typedef float T;
      const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
      FLASH_DMAX(D,
          flash_fwd_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0, st>>>(
              (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H,
              D, scale, causal))
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
