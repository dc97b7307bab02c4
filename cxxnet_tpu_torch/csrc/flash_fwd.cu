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
// with the TPU kernel's running max starting at -1e30 and masked logits
// set to -1e30, so a row with no key gives zeros. Unlike the TPU kernel,
// any S works (the ragged last tile is masked) and the tiles are this
// card's, not the config's attn_block.
//
// Bound on the H100: the long-context LM's call (B 8, S 2048, H 8, D 16,
// bf16, causal) does 4 * B * H * S^2 * D / 2 = 8.6 GFLOP of products over
// the causal half: 8.7 us at the bf16 tensor-core rate (989 TFLOP/s), the
// bound of the function; 0.13 ms on the f32 CUDA cores (67 TFLOP/s) where
// this kernel computes. Its bytes (4 MB) take 1.3 us.
//
// Design (flash.cuh has the thread layout): the TPU grid's sequential
// k-block axis becomes a loop inside the CTA. A CTA owns 64 query rows of
// one (batch, head) and walks the key tiles up to the diagonal: each tile
// of K and V is staged in shared memory as f32, each thread computes its
// row's logits for the whole tile into registers, takes the tile's max,
// rescales its accumulator once, and adds exp(s - m) v_j. The running max,
// sum and the 16-feature accumulator stay in registers. Tiles wholly
// above the diagonal are not visited. No tensor cores yet: a simple kernel
// that is right first.
#include "flash.cuh"

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

// q (B, Sq, H, D), k and v (B, Sk, H, D), o like q, all of one dtype
// (code of common.cuh), contiguous; lse (B, H, Sq) f32. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int D,
                         float scale, int causal, int dtype, void* stream) {
  if (!flash_args_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dtype, D,
      flash_fwd_kernel<T, DMAX><<<grid, kRows * (DMAX / kSlice), 0, st>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, D,
          scale, causal))
  return (int)cudaGetLastError();
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
