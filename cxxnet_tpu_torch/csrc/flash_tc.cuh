// Shared pieces of the tensor-core flash kernels (flash_fwd.cu's
// flash_fwd_tc, flash_bwd.cu's flash_bwd_dq_tc and flash_bwd_dkv_tc), for
// bf16 and f16 inputs.
//
// A CTA of 4 warps owns 64 rows of one (batch, head), a warp 16 of them,
// and walks tiles of 64 rows of the other operands (keys and values, or
// queries and dO) staged in the input type in shared memory, in a ring of
// three stages filled by cp.async. The warp's own rows stay in registers
// as A fragments of mma.sync m16n8k16 (mma.cuh has the fragment layouts);
// a tile's rows enter a product as B fragments by ldmatrix, plain when
// they are the columns of the result (S = Q K^T) and transposed when
// they are the summed axis (O = P V). An f32 accumulator of 16 x 16 is
// the A fragment of the next product once packed in pairs: a score
// matrix becomes the left operand of the product with the tile's rows
// without leaving registers. Such an operand goes in as hi + lo, two
// parts in the input type whose sum is it to about 2^-16 relative, at
// the cost of a second product.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace tc {

constexpr int kRows = 64;                // rows a CTA owns
constexpr int kWarps = kRows / 16;       // a warp owns 16 of them
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;                  // rows of a staged tile
constexpr int kStages = 3;               // tiles in flight or in use
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kLog2e = 1.442695040888963407f;

// elements per staged row: D's bucket plus 16 bytes, so the 8 rows of an
// ldmatrix phase fall in 8 different 16-byte bank groups
template <int DMAX> __host__ __device__ constexpr int pitch() {
  return DMAX + 8;
}
// kStages stages of a K and a V tile: the ring of the forward and of the
// dQ kernel
template <typename T, int DMAX>
__host__ __device__ constexpr int kv_ring_bytes() {
  return kStages * 2 * kBK * pitch<DMAX>() * (int)sizeof(T);
}
// scale * log2(e), the factor of the logits in exp2's units
__host__ inline float exp2_factor(float scale) {
  return (float)((double)scale * 1.4426950408889634);
}

// (x0, x1) as a packed pair of T
template <typename T> __device__ __forceinline__ unsigned pack2(float x0,
                                                               float x1);
template <> __device__ __forceinline__ unsigned pack2<__nv_bfloat16>(
    float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<unsigned*>(&h);
}
template <> __device__ __forceinline__ unsigned pack2<__half>(float x0,
                                                             float x1) {
  __half2 h = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<unsigned*>(&h);
}

// a packed pair of T as two floats
template <typename T> __device__ __forceinline__ float2 unpack2(unsigned u);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(
    unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(unsigned u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// the pair (x0, x1) as hi + lo, two packed pairs of T whose sum is x to
// about 2^-16 relative (bf16; f16 2^-22), both rounded to nearest: hi is
// x in T, lo the remainder times 2^SHIFT. SHIFT 11 keeps an f16
// remainder (at most 2^-11 |x|, so still at most |x|) out of f16's
// subnormals; its product is then scaled back (mma_hilo).
template <typename T, int SHIFT>
__device__ __forceinline__ void split2_rn(float x0, float x1, unsigned& hi,
                                          unsigned& lo) {
  hi = pack2<T>(x0, x1);
  const float2 hf = unpack2<T>(hi);
  lo = pack2<T>((x0 - hf.x) * (float)(1 << SHIFT),
                (x1 - hf.y) * (float)(1 << SHIFT));
}

// the forward's split of P in [0, 1]: bf16 truncates x to its top 16
// bits (a byte permute), lo is the exact remainder truncated the same
// way; f16 rounds both parts. Truncation biases every term the same way,
// which a long sum of small terms (the backward's dV over normalized P)
// or of terms that cancel (dS sums to 0 over a row) carries into the
// result: the backward rounds (split2_rn).
template <typename T> __device__ __forceinline__ void split2(
    float x0, float x1, unsigned& hi, unsigned& lo);
template <> __device__ __forceinline__ void split2<__nv_bfloat16>(
    float x0, float x1, unsigned& hi, unsigned& lo) {
  const unsigned u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  const float r0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
}
template <> __device__ __forceinline__ void split2<__half>(
    float x0, float x1, unsigned& hi, unsigned& lo) {
  split2_rn<__half, 0>(x0, x1, hi, lo);
}

// the shift of dS's split: f16's lo part needs one, bf16 (f32's exponent
// range) none
template <typename T> __host__ __device__ constexpr int lo_shift();
template <> __host__ __device__ constexpr int lo_shift<__nv_bfloat16>() {
  return 0;
}
template <> __host__ __device__ constexpr int lo_shift<__half>() {
  return 11;
}

// split2 (the forward's P) where a split's SHIFT is kCut
constexpr int kCut = -1;
template <typename T, int SHIFT>
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  if (SHIFT == kCut)
    split2<T>(x0, x1, hi, lo);
  else
    split2_rn<T, (SHIFT < 0 ? 0 : SHIFT)>(x0, x1, hi, lo);
}

// the A fragment (16 rows x 16 columns) of two accumulator blocks of 16 x
// 8, x0 the first 8 columns, as hi + lo split by split_pair<T, SHIFT>
template <typename T, int SHIFT>
__device__ __forceinline__ void to_a(const float (&x0)[4],
                                     const float (&x1)[4], unsigned (&hi)[4],
                                     unsigned (&lo)[4]) {
  split_pair<T, SHIFT>(x0[0], x0[1], hi[0], lo[0]);   // row gid
  split_pair<T, SHIFT>(x0[2], x0[3], hi[1], lo[1]);   // row gid + 8
  split_pair<T, SHIFT>(x1[0], x1[1], hi[2], lo[2]);   // columns + 8
  split_pair<T, SHIFT>(x1[2], x1[3], hi[3], lo[3]);
}

// copy rows [r0, r0 + kBK) of a (B, S, H, D) tensor's (b, h) slice into
// a staged tile, zeros past S and past D: 16-byte copies (VEC: D % 8 == 0
// and 16-byte aligned bases) or 4-byte ones
template <typename T, int DMAX, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int64_t rs,
                                          int r0, int S, int D) {
  constexpr int P = pitch<DMAX>();
  constexpr int UNIT = VEC ? 8 : 2;            // elements per copy
  constexpr int UPR = DMAX / UNIT;             // copies per row
  constexpr int N = kBK * UPR;
#pragma unroll 8
  for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (N % kThreads && c >= N) break;
    const int r = c / UPR, d = (c % UPR) * UNIT;
    const bool ok = r0 + r < S && d < D;
    const T* src = ok ? base + (int64_t)(r0 + r) * rs + d : base;
    if (VEC)
      ptx::cp_async16(dst + r * P + d, src, ok);
    else
      ptx::cp_async4(dst + r * P + d, src, ok);
  }
}

// the warp's 16 rows [row0, row0 + 16) of a (B, S, H, D) tensor's (b, h)
// slice (base: its row 0) as A fragments, once from global memory: f[kd][r]
// holds row gid + 8 (r & 1), features 16 kd + 2 tig + 8 (r >> 1) and the
// next; zeros past S and D
template <typename T, int KD>
__device__ __forceinline__ void load_a(unsigned (&f)[KD][4], const T* base,
                                       int64_t rs, int row0, int S, int D) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gid + (r & 1) * 8;
      const int col = kd * 16 + tig * 2 + (r >> 1) * 8;
      f[kd][r] = (row < S && col < D)
          ? __ldg(reinterpret_cast<const unsigned*>(base + row * rs + col))
          : 0u;
    }
}

// the A fragments of the 16 staged rows at `rows` (as load_a), by
// ldmatrix
template <typename T, int KD, int P>
__device__ __forceinline__ void ldmatrix_a(unsigned (&f)[KD][4],
                                           const T* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ptx::ldmatrix_x4(f[kd], rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * P
                                + kd * 16 + (lane >> 4) * 8);
}

// c0, c1 += A B^T for the 16 staged rows at `rows` (a tile's rows as the
// 16 columns of the result, c0 the first 8), over KD k16 steps of
// features; the rows by ldmatrix
template <typename T, int KD, int P>
__device__ __forceinline__ void mma_rows(float (&c0)[4], float (&c1)[4],
                                         const unsigned (&a)[KD][4],
                                         const T* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    unsigned bf[4];
    ptx::ldmatrix_x4(bf, rows + ((lane >> 4) * 8 + (lane & 7)) * P + kd * 16
                             + ((lane >> 3) & 1) * 8);
    ptx::mma_16816<T>(c0, a[kd], bf[0], bf[1]);
    ptx::mma_16816<T>(c1, a[kd], bf[2], bf[3]);
  }
}

// acc += (hi + lo / 2^SHIFT) R for the 16 staged rows R at `rows` (the
// summed axis), over the NO n8 blocks of features; R by ldmatrix.trans.
// SHIFT > 0: the lo product goes to an accumulator of its own, scaled
// back as it is added
template <typename T, int NO, int P, int SHIFT>
__device__ __forceinline__ void mma_hilo(float (&acc)[NO][4],
                                         const unsigned (&hi)[4],
                                         const unsigned (&lo)[4],
                                         const T* rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nd = 0; nd < NO / 2; ++nd) {
    unsigned vf[4];
    ptx::ldmatrix_x4_trans(vf, rows + (((lane >> 3) & 1) * 8 + (lane & 7)) * P
                                   + nd * 16 + (lane >> 4) * 8);
    if (SHIFT == 0) {
      ptx::mma_16816<T>(acc[2 * nd], hi, vf[0], vf[1]);
      ptx::mma_16816<T>(acc[2 * nd], lo, vf[0], vf[1]);
      ptx::mma_16816<T>(acc[2 * nd + 1], hi, vf[2], vf[3]);
      ptx::mma_16816<T>(acc[2 * nd + 1], lo, vf[2], vf[3]);
    } else {
      float t[2][4] = {};
      ptx::mma_16816<T>(acc[2 * nd], hi, vf[0], vf[1]);
      ptx::mma_16816<T>(t[0], lo, vf[0], vf[1]);
      ptx::mma_16816<T>(acc[2 * nd + 1], hi, vf[2], vf[3]);
      ptx::mma_16816<T>(t[1], lo, vf[2], vf[3]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[2 * nd][r] = fmaf(t[0][r], 1.f / (1 << SHIFT), acc[2 * nd][r]);
        acc[2 * nd + 1][r] =
            fmaf(t[1][r], 1.f / (1 << SHIFT), acc[2 * nd + 1][r]);
      }
    }
  }
}

// the warp's 16 rows [row0, row0 + 16) of the accumulator acc (NO n8
// blocks of features) into a (B, S, H, D) tensor's (b, h) slice (base:
// its row 0), in T, rows past S and features past D left out. VEC: through
// `so`, 16 staged rows that no other warp touches, then 16-byte stores;
// else 4-byte stores
template <typename T, int DMAX, bool VEC>
__device__ __forceinline__ void store_rows(T* base, int64_t rs, int row0,
                                           int S, int D,
                                           const float (&acc)[DMAX / 8][4],
                                           T* so) {
  constexpr int P = pitch<DMAX>(), NO = DMAX / 8;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  if (VEC) {
#pragma unroll
    for (int nb = 0; nb < NO; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<unsigned*>(so + (gid + i * 8) * P + nb * 8 +
                                     tig * 2) =
            pack2<T>(acc[nb][2 * i], acc[nb][2 * i + 1]);
    __syncwarp();
    constexpr int CPR = DMAX / 8;
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, d = (c % CPR) * 8, row = row0 + r;
      if (row < S && d < D)
        *reinterpret_cast<uint4*>(base + row * rs + d) =
            *reinterpret_cast<const uint4*>(so + r * P + d);
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < NO; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + gid + i * 8, col = nb * 8 + tig * 2;
        if (row < S && col < D)
          *reinterpret_cast<unsigned*>(base + row * rs + col) =
              pack2<T>(acc[nb][2 * i], acc[nb][2 * i + 1]);
      }
  }
}

// allow `kernel` `bytes` of dynamic shared memory: the opt-in past 48 KB
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// 16-byte copies and stores when D % 8 == 0 and every base is 16-byte
// aligned; 4-byte ones otherwise (D is even). -1: a base is not even
// 4-byte aligned
__host__ inline int vec_mode(int D, uintptr_t any) {
  if (any % 4) return -1;
  return D % 8 == 0 && any % 16 == 0;
}

}  // namespace tc
