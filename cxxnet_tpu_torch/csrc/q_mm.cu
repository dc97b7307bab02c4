// int8 x int8 -> int32 matrix product with the dequant, bias and relu
// epilogue fused: y = act(float(xq @ wq) * factor + bias), per group.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_quant.py:_q_mm_kernel
// (pallas_call in _q_mm_pallas). Same function: xq int8 (M, K) against the
// int8 weight, an int32 accumulator, then per output column n the f32
// epilogue. The epilogue rounds twice, as the port's plain version
// (ops/fused_quant.q_mm_plain) does: __int2float_rn(acc), __fmul_rn by
// factor[n], __fadd_rn of bias[n], then relu; so the two are bit-equal
// on the card. (Compiled XLA contracts acc * factor + bias into one FMA;
// against the JAX package the difference is one f32 rounding.)
//
// Layouts, as the wrapper hands them: A is (M, >= G*K) with row stride
// lda, group g reading columns [g*K, (g+1)*K) (the int8 im2col of a
// grouped conv, or the quantized rows of a fullc with G = 1); B is
// (G*N, >= K) with row stride ldb, the weight transposed so that K is
// contiguous (group g its rows [g*N, (g+1)*N)); factor and bias are
// (G*N,) f32 (bias may be NULL); y is (M, G*N) f32 contiguous, group g
// writing its columns [g*N, (g+1)*N). The int8 conv pads K to a multiple
// of 16 with zero columns in both operands (ops/fused_quant.py), which
// leaves the exact sum as it is and keeps every row 16-byte aligned.
//
// Bound on the H100: the larger of 2*M*N*K*G operations at the int8
// tensor cores' 1,979 TOPS and the bytes (A and B once, y, factor and
// bias) at 3.35 TB/s. fc6 at M 32 (K 9216, N 4096) reads 37.7 MB of
// weight: 11.3 us. conv1 as im2col at bucket 32 (M 401,408, K 147, N 64):
// 59 MB of A and 103 MB of y, about 48 us. Both are bound by bytes.
//
// Design. Output tiles of BM x 64 (BM 16 or 32 for M <= 32: the fc layers
// and the 7x7 convs at small buckets; 64; 128 for the im2col rows), K in
// steps of BK bytes through a ring of 4 stages in shared memory filled by
// 16-byte cp.async, so the copies of steps k+1..k+3 are in flight while
// mma.sync m16n8k32 s8 (int32 accumulators) runs on step k; fragments by
// ldmatrix (rows padded by 16 bytes: free of bank conflicts). Where the
// output tiles do not fill the card, K is split over `splits` CTAs per
// tile (the grid's z): each writes its int32 partial tile to a workspace,
// and a per-tile arrival counter picks the last CTA, which adds the other
// splits' partials to its own in split order (int32 sums are exact in any
// order), runs the epilogue and resets the counter for the next launch:
// one launch, no memset. The epilogue stages the tile in shared memory and stores 16-byte
// vectors of f32, factor and bias loaded once per column block.
// ops/fused_quant.q_mm_plan chooses BM, the split and the variant. Operands
// that are not 16-byte aligned (K % 16 != 0) take the same kernel with
// synchronous 4-byte gathers in place of the copy ring.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BN = 64;
constexpr int STAGES = 4;

template <int BM_, int BK_, int WARPS_M, int WARPS_N> struct Cfg {
  static constexpr int BM = BM_, BK = BK_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;   // m16 / n8 fragments
  static constexpr int WARPS_N_ = WARPS_N;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int NACC = MI * NI * 4;          // accumulators a thread
  static constexpr int PITCH = BK + 16;             // bytes a staged row
  static constexpr int STAGE = (BM + BN) * PITCH;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int OPITCH = BN + 4;             // ints a staged out row
  static_assert(NI % 2 == 0, "B fragments come two n8 blocks at a time");
  static_assert(BM * OPITCH * 4 <= SMEM, "output tile must fit the ring");
};

// the row tiles (ops/fused_quant.Q_MM_TILES): warp tiles 16x16, 32x16,
// 32x32, 32x32
using T16 = Cfg<16, 128, 1, 4>;
using T32 = Cfg<32, 128, 1, 4>;
using T64 = Cfg<64, 64, 2, 2>;
using T128 = Cfg<128, 64, 4, 2>;

// rows [0, rows) x columns [k0, k0 + BK) of the matrix at g (row stride
// ld, K columns valid) into a staged tile, zeros outside: 16-byte
// cp.async (VEC) or synchronous 4-byte gathers
template <class C, int ROWS, bool VEC>
__device__ __forceinline__ void load(int8_t* __restrict__ sm,
                                     const int8_t* __restrict__ g, int64_t ld,
                                     int rows, int k0, int K) {
  if (VEC) {
    constexpr int CPR = C::BK / 16;
    for (int c = threadIdx.x; c < ROWS * CPR; c += C::THREADS) {
      const int r = c / CPR, kk = (c % CPR) * 16;
      const bool ok = r < rows && k0 + kk < K;
      ptx::cp_async16(sm + r * C::PITCH + kk, ok ? g + r * ld + k0 + kk : g,
                      ok);
    }
  } else {
    constexpr int WPR = C::BK / 4;
    for (int c = threadIdx.x; c < ROWS * WPR; c += C::THREADS) {
      const int r = c / WPR, kk = (c % WPR) * 4;
      unsigned v = 0u;
      if (r < rows) {
        const int8_t* p = g + r * ld + k0 + kk;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + kk + j < K) v |= ((unsigned)(uint8_t)p[j]) << (8 * j);
      }
      *reinterpret_cast<unsigned*>(sm + r * C::PITCH + kk) = v;
    }
  }
}

__device__ __forceinline__ float epilogue(int acc, float f, float b,
                                          bool has_bias, int relu) {
  float v = __fmul_rn(__int2float_rn(acc), f);
  if (has_bias) v = __fadd_rn(v, b);
  return relu ? relu_f32(v) : v;
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS)
q_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            const float* __restrict__ factor, const float* __restrict__ bias,
            float* __restrict__ Y, int M, int K, int N, int G, int64_t lda,
            int64_t ldb, int relu, int vec_out, int splits, int kps,
            int* __restrict__ ws, int* __restrict__ counters) {
  constexpr int BM = C::BM, BK = C::BK, PITCH = C::PITCH;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int is_last;
  const int mt = blockIdx.x, nt = blockIdx.y;
  const int grp = blockIdx.z / splits, split = blockIdx.z % splits;
  const int m0 = mt * BM, n0 = nt * BN;
  const int8_t* a_blk = A + (int64_t)m0 * lda + (int64_t)grp * K;
  const int8_t* b_blk = B + ((int64_t)grp * N + n0) * ldb;
  const int rows_a = min(BM, M - m0), rows_b = min(BN, N - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / C::WARPS_N_) * C::WM, wn = (warp % C::WARPS_N_) * C::WN;
  const int s0 = split * kps;
  const int nsteps = min((K + BK - 1) / BK, s0 + kps) - s0;

  int acc[C::MI][C::NI][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto issue = [&](int i) {   // step s0 + i into stage i % STAGES
    int8_t* st = smem + (i % STAGES) * C::STAGE;
    const int k0 = (s0 + i) * BK;
    load<C, BM, VEC>(st, a_blk, lda, rows_a, k0, K);
    load<C, BN, VEC>(st + BM * PITCH, b_blk, ldb, rows_b, k0, K);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nsteps) issue(i);
    ptx::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    ptx::cp_async_wait<STAGES - 2>();   // step i has landed for this thread
    __syncthreads();   // ... for every thread; step i - 1's stage is free
    if (i + STAGES - 1 < nsteps) issue(i + STAGES - 1);
    ptx::cp_async_commit();
    const int8_t* sA = smem + (i % STAGES) * C::STAGE;
    const int8_t* sB = sA + BM * PITCH;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[C::MI][4], b[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ptx::ldmatrix_x4(a[mi], sA + (wm + mi * 16 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)) * PITCH +
                                    ks + (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < C::NI; nj += 2) {
        unsigned t[4];
        ptx::ldmatrix_x4(t, sB + (wn + nj * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                     PITCH +
                                 ks + ((lane >> 3) & 1) * 16);
        b[nj][0] = t[0];
        b[nj][1] = t[1];
        b[nj + 1][0] = t[2];
        b[nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < C::NI; ++nj)
          ptx::mma_s8(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }
  ptx::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the output tile

  if (splits > 1) {
    // partials as [tile][split][accumulator][thread]: coalesced both ways
    const int tile = (grp * gridDim.y + nt) * gridDim.x + mt;
    int* part = ws + (int64_t)tile * splits * C::NACC * C::THREADS;
    int* mine = part + (int64_t)split * C::NACC * C::THREADS;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          __stcg(mine + ((i * C::NI + j) * 4 + r) * C::THREADS + tid,
                 acc[i][j][r]);
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the other splits' partials in split order, U splits' at a time in
    // flight (few registers: the kernel's count is the mainloop's)
    constexpr int U = C::NACC >= 32 ? 1 : 2;
    int* flat = &acc[0][0][0];
    for (int sb = 0; sb < splits; sb += U) {
      int v[U][C::NACC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < C::NACC; ++i) {
          const int s = sb + u;
          v[u][i] = s >= splits || s == split
              ? 0
              : __ldcg(part + ((int64_t)s * C::NACC + i) * C::THREADS + tid);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < C::NACC; ++i) flat[i] += v[u][i];
    }
    if (tid == 0) counters[tile] = 0;   // ready for the next launch
  }

  // the int32 tile through shared memory: c0, c1 at row gid, c2, c3 at
  // row gid + 8; columns 2 tig and the next
  int* so = reinterpret_cast<int*>(smem);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(so + (wm + i * 16 + gid + h * 8) * C::OPITCH +
                                 wn + j * 8 + tig * 2) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();

  const int64_t ldy = (int64_t)G * N;
  float* y_blk = Y + (int64_t)m0 * ldy + (int64_t)grp * N + n0;
  const float* f_blk = factor + (int64_t)grp * N + n0;
  const float* bias_blk =
      bias == nullptr ? nullptr : bias + (int64_t)grp * N + n0;
  const bool has_bias = bias != nullptr;
  if (vec_out) {
    // a thread keeps one 4-column chunk: factor and bias loaded once
    constexpr int CPR = BN / 4;
    const int col = (tid % CPR) * 4;
    if (col >= rows_b) return;
    const float4 f = *reinterpret_cast<const float4*>(f_blk + col);
    const float4 bb = has_bias ? *reinterpret_cast<const float4*>(bias_blk + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = tid / CPR; r < rows_a; r += C::THREADS / CPR) {
      const int4 a = *reinterpret_cast<const int4*>(so + r * C::OPITCH + col);
      float4 out;
      out.x = epilogue(a.x, f.x, bb.x, has_bias, relu);
      out.y = epilogue(a.y, f.y, bb.y, has_bias, relu);
      out.z = epilogue(a.z, f.z, bb.z, has_bias, relu);
      out.w = epilogue(a.w, f.w, bb.w, has_bias, relu);
      *reinterpret_cast<float4*>(y_blk + r * ldy + col) = out;
    }
  } else {
    for (int c = tid; c < BM * BN; c += C::THREADS) {
      const int r = c / BN, col = c % BN;
      if (r < rows_a && col < rows_b)
        y_blk[r * ldy + col] =
            epilogue(so[r * C::OPITCH + col], f_blk[col],
                     has_bias ? bias_blk[col] : 0.f, has_bias, relu);
    }
  }
}

template <class C, bool VEC>
int launch(const void* a, const void* b, const void* factor, const void* bias,
           void* y, int M, int K, int N, int G, int64_t lda, int64_t ldb,
           int relu, int splits, int kps, void* ws, void* counters,
           cudaStream_t st) {
  // the splits must cover K's steps of this tile's BK, none empty
  const int steps = (K + C::BK - 1) / C::BK;
  if ((long long)kps * splits < steps || (long long)kps * (splits - 1) >= steps)
    return (int)cudaErrorInvalidValue;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        q_mm_kernel<C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte output stores: N % 4 == 0 and 16-byte aligned y, factor, bias
  const int vec_out = N % 4 == 0 &&
      ((uintptr_t)y | (uintptr_t)factor | (uintptr_t)bias) % 16 == 0;
  const dim3 grid((M + C::BM - 1) / C::BM, (N + BN - 1) / BN, G * splits);
  q_mm_kernel<C, VEC><<<grid, C::THREADS, C::SMEM, st>>>(
      (const int8_t*)a, (const int8_t*)b, (const float*)factor,
      (const float*)bias, (float*)y, M, K, N, G, lda, ldb, relu, vec_out,
      splits, kps, (int*)ws, (int*)counters);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_bm(int bm, const void* a, const void* b, const void* factor,
              const void* bias, void* y, int M, int K, int N, int G,
              int64_t lda, int64_t ldb, int relu, int splits, int kps,
              void* ws, void* counters, cudaStream_t st) {
  switch (bm) {
    case 16: return launch<T16, VEC>(a, b, factor, bias, y, M, K, N, G, lda,
                                     ldb, relu, splits, kps, ws, counters, st);
    case 32: return launch<T32, VEC>(a, b, factor, bias, y, M, K, N, G, lda,
                                     ldb, relu, splits, kps, ws, counters, st);
    case 64: return launch<T64, VEC>(a, b, factor, bias, y, M, K, N, G, lda,
                                     ldb, relu, splits, kps, ws, counters, st);
    case 128: return launch<T128, VEC>(a, b, factor, bias, y, M, K, N, G, lda,
                                       ldb, relu, splits, kps, ws, counters,
                                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: (M, >= G*K) int8, row stride lda; b: (G*N, >= K) int8, row stride
// ldb; factor: (G*N,) f32; bias: (G*N,) f32 or NULL; y: (M, G*N) f32
// contiguous. bm: the row tile (16, 32, 64 or 128); splits: CTAs over K
// per output tile, each taking kps steps of the tile's BK; ws: int32
// workspace of tiles * splits * bm * 64 and counters: int32 of tiles,
// zero before the first launch (the kernel leaves them zero), both unused
// when splits == 1. aligned: 16-byte copies (K, lda, ldb multiples of 16
// and 16-byte aligned bases, checked here). Returns a cudaError_t (0 =
// launched).
extern "C" int q_mm(const void* a, const void* b, const void* factor,
                    const void* bias, void* y, int M, int K, int N, int G,
                    long long lda, long long ldb, int relu, int bm,
                    int splits, int kps, int aligned, void* ws,
                    void* counters, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || G <= 0 || splits <= 0 || kps <= 0 ||
      lda < (long long)G * K || ldb < K)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if ((N + BN - 1) / BN > 65535 || (long long)G * splits > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (aligned && (K % 16 || lda % 16 || ldb % 16 ||
                  ((uintptr_t)a | (uintptr_t)b) % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  return aligned ? launch_bm<true>(bm, a, b, factor, bias, y, M, K, N, G, lda,
                                   ldb, relu, splits, kps, ws, counters, s)
                 : launch_bm<false>(bm, a, b, factor, bias, y, M, K, N, G,
                                    lda, ldb, relu, splits, kps, ws, counters,
                                    s);
}

extern "C" const char* q_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
