// Per-channel column sums over (N, C) rows in one launch, with 16-byte
// loads and no float atomics. Its users: the batch-norm moments of
// bn_fwd (bn_fwd.cu) and bn_sums (bn_sync.cu), through bn_moments.cuh's
// MomentsVec (sum x, sum x^2) and SqDevVec (sum (x - mean)^2) ops; the
// backward sums of bn_bwd_sums (bn_sync.cu) and bn_bwd (bn_bwd.cu),
// through bn_bwd_vec.cuh's BwdSumsVec op (two sums a channel); and the
// epilogue's dbias (epilogue_bwd.cu's EpiBwdVec op, one sum a channel).
//
// Bound on the H100 (3.35 TB/s): the bytes of the input rows, read once.
// The design it replaced, a two-stage scalar column sum (one 2-byte load
// per stream and channel, a (32, 8) block a 32-channel tile, then a
// one-CTA finalize that walked every partial of a channel in a serial
// chain), took 0.1768 ms for bn_bwd_sums at bn_stem1 per rank ((802,816,
// 64) bf16 with the relu mask: 308 MB, bound 0.0920 ms) on an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py, phase 11's times). This design
// takes 0.105 ms there on the same card, 1.14x its bound (PERF.md row
// 10); the one-stream moments of bn_sums there 0.0418 ms (102.75 MB,
// 1.36x its bound; the two-stage design 0.0740, chip_smoke.py --ab).
//
// Design. A CTA of kVecThreads threads owns a block of rows and a tile
// of channels. Thread t takes V = 16 / sizeof(T) neighbouring channels
// (its channel group cg = t % cgt of the tile's cgt groups) on row lane
// t / cgt, and loads each row of each stream as one 16-byte vector: at
// C = 64 bf16, 8 threads cover a row and a warp reads 4 whole rows (512
// contiguous bytes). The op's per-channel constants sit in registers.
// A lane takes every lanes-th row of the block, kVecRows rows of every
// stream in flight at a time, and the grid is one wave of kVecCtasPerSm
// CTAs a SM: 74 KB of loads in flight a SM with three streams (of 1 to
// 16 CTAs a SM, 3 measured fastest: fewer leave too few bytes in flight,
// more add a tail); with the one stream of the moments, 4 or 8 rows in
// flight measured no faster than 2. The lanes' sums meet in shared
// memory and are added in lane order; each CTA writes its (NS, tile)
// partials into the wrapper's workspace; an integer arrival counter per
// tile picks the CTA that arrives last, which adds the tile's partials
// in row-block order, spread over all of its threads (fvec partials a
// load, `chunks` runs of row blocks added apart and then in order),
// writes the sums and resets the counter for the next launch. So two
// runs on the same input agree bit for bit, and the counters need no
// memset. With one row block (G = 1) the lanes' sums are the column
// sums: the CTA writes them and skips the partials, the counter and the
// last pass (whose additions, 0 + the one partial, would be exact).
// Where C is not a multiple of V or a base is not 16-byte aligned the
// wrapper plans V = 1 (one element a load).
//
// ops/fused_norm.colsum_vec_plan gives cgt, the tiles, the row blocks
// and fvec; ops/fused_norm.colsum_vec_depth the longest chain of f32
// additions behind one sum: a lane's rows, then the lanes, then a run of
// row blocks, then the runs. An op with one sum (NS = 1) writes and adds
// half the partials; its last CTA spreads the runs over as many threads.
#pragma once

#include "common.cuh"

constexpr int kVecThreads = 256;
constexpr int kVecRows = 2;     // rows of each stream a thread has in flight
constexpr int kVecCtasPerSm = 3; // resident CTAs a SM (at most 85 registers)
constexpr int kVecShared = 2 * kVecThreads * 8;   // floats of shared memory

// runs the statement(s) with T the element type of dtype code `dtype`
#define DISPATCH(dtype, ...)                                       \
  switch (dtype) {                                                 \
    case kF32: { using T = float; __VA_ARGS__; } break;            \
    case kBF16: { using T = __nv_bfloat16; __VA_ARGS__; } break;   \
    case kF16: { using T = __half; __VA_ARGS__; } break;           \
    default: return (int)cudaErrorInvalidValue;                    \
  }

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Whether colsum_vec_plan's (vec, cgt, tiles, blocks, rows_per, fvec)
// covers (N, C) rows: the channel groups in whole tiles, the rows in the
// row blocks, fvec 4 only where the partials allow float4 loads.
static inline bool colsum_plan_ok(int64_t N, int C, int vec, int cgt,
                                  int tiles, int blocks, int64_t rows_per,
                                  int fvec) {
  if (vec < 1 || C % vec) return false;
  const int groups = C / vec;
  return cgt >= 1 && cgt <= kVecThreads &&
         tiles == (groups + cgt - 1) / cgt && blocks >= 1 && rows_per >= 1 &&
         (int64_t)blocks * rows_per >= N &&
         (fvec == 1 || (fvec == 4 && C % 4 == 0 && (cgt * vec) % 4 == 0));
}

// The last CTA's pass over one tile's partials: sum q of the tile's NS * cw
// (a, then b when NS = 2) is the sum over row blocks g of
// part[g * NS * C + s * C + c], taken in `chunks` runs of gper row blocks,
// FV sums a load; each run's total lands in sc[run * NS * cw + q].
template <int NS, int FV>
__device__ __forceinline__ void sum_runs(const float* __restrict__ part,
                                         int G, int C, int c_base, int cw,
                                         int chunks, float* sc) {
  const int units = NS * cw / FV;
  const int gper = (G + chunks - 1) / chunks;
  for (int w = threadIdx.x; w < units * chunks; w += kVecThreads) {
    const int u = w % units, run = w / units;
    const int q0 = u * FV;
    const int s = q0 / cw, j = q0 % cw;
    const float* src = part + (int64_t)s * C + c_base + j;
    const int g0 = run * gper;
    const int g1 = g0 + gper < G ? g0 + gper : G;
    float t[FV];
#pragma unroll
    for (int k = 0; k < FV; ++k) t[k] = 0.f;
#pragma unroll 8
    for (int g = g0; g < g1; ++g) {
      const float* p = src + (int64_t)g * NS * C;
      if constexpr (FV == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
        t[0] = __fadd_rn(t[0], v.x);
        t[1] = __fadd_rn(t[1], v.y);
        t[2] = __fadd_rn(t[2], v.z);
        t[3] = __fadd_rn(t[3], v.w);
      } else {
        t[0] = __fadd_rn(t[0], __ldcg(p));
      }
    }
#pragma unroll
    for (int k = 0; k < FV; ++k) sc[run * NS * cw + q0 + k] = t[k];
  }
}

// Op: static constexpr int V; static constexpr int NS (1 or 2 sums a
// channel); struct Row (one row's raw vectors); struct Consts
// (per-channel constants); __device__ Consts consts(int c0) const;
// __device__ Row load(int64_t i) const (the V channels from element i
// on); __device__ void add(const Row&, const Consts&, float* a, float* b)
// const (adds them into a[0..V) and, when NS = 2, b[0..V)).
//
// grid (G row blocks, tiles); block kVecThreads. part: G * NS * C floats;
// counters: one per tile, zero; out: (NS, C).
template <typename Op>
__global__ void __launch_bounds__(kVecThreads, kVecCtasPerSm)
    colsum_vec(Op op, int64_t N, int C, int cgt, int64_t rows_per,
               int fvec, float* __restrict__ part,
               unsigned* __restrict__ counters, float* __restrict__ out) {
  constexpr int V = Op::V;
  constexpr int NS = Op::NS;
  static_assert(NS == 1 || NS == 2, "one or two sums a channel");
  __shared__ __align__(16) float sh[kVecShared];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const int lanes = kVecThreads / cgt;
  const int lane = tid / cgt, cg = tid % cgt;
  const int cw_full = cgt * V;
  const int c_base = blockIdx.y * cw_full;
  const int cw = C - c_base < cw_full ? C - c_base : cw_full;
  const int G = gridDim.x;
  const bool active = lane < lanes && cg * V < cw;

  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  if (active) {
    const int c0 = c_base + cg * V;
    const typename Op::Consts kc = op.consts(c0);
    const int64_t r0 = (int64_t)blockIdx.x * rows_per + lane;
    const int64_t end = (int64_t)blockIdx.x * rows_per + rows_per;
    const int64_t r1 = end < N ? end : N;
    const int64_t nrows = r0 < r1 ? (r1 - r0 + lanes - 1) / lanes : 0;
    const int64_t step = (int64_t)lanes * C;
    int64_t i = r0 * C + c0;
    int64_t k = 0;
    for (; k + kVecRows <= nrows; k += kVecRows) {
      typename Op::Row rw[kVecRows];
#pragma unroll
      for (int u = 0; u < kVecRows; ++u) rw[u] = op.load(i + u * step);
#pragma unroll
      for (int u = 0; u < kVecRows; ++u) op.add(rw[u], kc, a, b);
      i += kVecRows * step;
    }
    for (; k < nrows; ++k, i += step) op.add(op.load(i), kc, a, b);
  }

  // the lanes' sums, [lane][channel of the tile] for a, then for b
  float* sa = sh;
  float* sb = sh + kVecThreads * V;
  if (active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sa[lane * cw_full + cg * V + k] = a[k];
      if (NS == 2) sb[lane * cw_full + cg * V + k] = b[k];
    }
  }
  __syncthreads();
  float* mine = part + (int64_t)blockIdx.x * NS * C + c_base;
  for (int q = tid; q < NS * cw; q += kVecThreads) {
    const int s = q / cw, j = q % cw;
    const float* src = (s ? sb : sa) + j;
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t = __fadd_rn(t, src[l * cw_full]);
    if (G == 1)
      out[(int64_t)s * C + c_base + j] = t;   // the sums themselves
    else
      __stcg(mine + (int64_t)s * C + j, t);
  }
  if (G == 1) return;

  // the CTA that arrives last at its tile adds the tile's partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + blockIdx.y, 1u) == (unsigned)G - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int units = NS * cw / fvec;
  int chunks = kVecThreads / units;
  chunks = chunks < 1 ? 1 : (chunks > G ? G : chunks);
  if (fvec == 4)
    sum_runs<NS, 4>(part, G, C, c_base, cw, chunks, sh);
  else
    sum_runs<NS, 1>(part, G, C, c_base, cw, chunks, sh);
  __syncthreads();
  for (int q = tid; q < NS * cw; q += kVecThreads) {
    float t = 0.f;
    for (int run = 0; run < chunks; ++run)
      t = __fadd_rn(t, sh[run * NS * cw + q]);
    const int s = q / cw, j = q % cw;
    out[(int64_t)s * C + c_base + j] = t;
  }
  if (tid == 0) counters[blockIdx.y] = 0;   // ready for the next launch
}
