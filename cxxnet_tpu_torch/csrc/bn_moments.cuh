// The batch-norm moments over (N, C) rows as ops of colsum_vec.cuh's
// one-launch column sums, and the one formula that turns them into the
// statistics. bn_fwd (bn_fwd.cu) and bn_sums (bn_sync.cu) both take them,
// so their sums of the same rows agree bit for bit.
//
//   MomentsVec<T, V, 2>: S1 = sum x, S2 = sum x * x   (one-pass moments,
//                        and bn_sums)
//   MomentsVec<T, V, 1>: S1 = sum x                   (two-pass, first)
//   SqDevVec<T, V>:      S2 = sum (x - mean)^2, mean = S1 / N from the
//                        first pass's S1               (two-pass, second)
//
// Each op loads x as one 16-byte vector of its V channels (V = 1 where
// the plan cannot) and adds with rounded f32 operations (__fadd_rn,
// __fmul_rn, __fsub_rn: no contraction into an FMA), so the sums are
// bit-equal to the numpy emulation of colsum_vec's order
// (tests/torch_colsum_order.py).
#pragma once

#include "colsum_vec.cuh"

// mean = S1 / n
__device__ __forceinline__ float bn_mean(float s1, float n) {
  return __fdiv_rn(s1, n);
}

// one-pass var = max(S2 / n - mean^2, 0), a NaN kept (fmaxf would drop
// it, where jnp.maximum and torch.clamp keep it)
__device__ __forceinline__ float bn_var(float s2, float n, float mean) {
  const float v = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  return v < 0.f ? 0.f : v;
}

// rstd = rsqrt(var + eps)
__device__ __forceinline__ float bn_rstd(float var, float eps) {
  return rsqrtf(__fadd_rn(var, eps));
}

// a[k] += x[k] and, with NS = 2, b[k] += x[k] * x[k] over V channels a load
template <typename T, int V_, int NS_>
struct MomentsVec {
  static constexpr int V = V_;
  static constexpr int NS = NS_;
  using IO = VecIO<T, V>;
  struct Row {
    typename IO::Raw x;
  };
  struct Consts {};
  const T* x;
  __device__ Consts consts(int) const { return Consts{}; }
  __device__ Row load(int64_t i) const { return Row{IO::load(x + i)}; }
  __device__ void add(const Row& r, const Consts&, float* a,
                      float* b) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = IO::at(r.x, j);
      a[j] = __fadd_rn(a[j], v);
      if (NS == 2) b[j] = __fadd_rn(b[j], __fmul_rn(v, v));
    }
  }
};

// a[k] += (x[k] - mean[k])^2 over V channels a load, mean = S1 / n
template <typename T, int V_>
struct SqDevVec {
  static constexpr int V = V_;
  static constexpr int NS = 1;
  using IO = VecIO<T, V>;
  struct Row {
    typename IO::Raw x;
  };
  struct Consts {
    float mean[V];
  };
  const T* x;
  const float* s1;
  float n;
  __device__ Consts consts(int c0) const {
    Consts k;
#pragma unroll
    for (int j = 0; j < V; ++j) k.mean[j] = bn_mean(s1[c0 + j], n);
    return k;
  }
  __device__ Row load(int64_t i) const { return Row{IO::load(x + i)}; }
  __device__ void add(const Row& r, const Consts& k, float* a,
                      float*) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = __fsub_rn(IO::at(r.x, j), k.mean[j]);
      a[j] = __fadd_rn(a[j], __fmul_rn(d, d));
    }
  }
};

// which sums a launch of launch_moments takes
enum MomentsPass {
  kSumsX2 = 0,   // sums[0..C) = sum x, sums[C..2C) = sum x^2
  kSumX = 1,     // sums[0..C) = sum x
  kSqDev = 2,    // sums[C..2C) = sum (x - sums[c] / N)^2
};

template <typename Op>
static void launch_op(const Op& op, float* out, float* part,
                      unsigned* counters, int64_t N, int C, int cgt,
                      int tiles, int blocks, int64_t rows_per, int fvec,
                      cudaStream_t s) {
  colsum_vec<<<dim3(blocks, tiles), kVecThreads, 0, s>>>(
      op, N, C, cgt, rows_per, fvec, part, counters, out);
}

// One launch of the moments under colsum_vec_plan's (vec, cgt, tiles,
// blocks, rows_per, fvec): sums (2, C) f32; part: blocks * 2 * C floats;
// counters: `tiles` zero unsigned ints, left zero. Returns
// cudaErrorInvalidValue for a plan the inputs do not allow.
template <typename T>
static int launch_moments(const void* xv, float* sums, float* part,
                          unsigned* counters, int64_t N, int C, int vec,
                          int cgt, int tiles, int blocks, int64_t rows_per,
                          int fvec, int pass, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (vec != 1 && (vec != VW || C % VW || !aligned16(xv)))
    return (int)cudaErrorInvalidValue;
  if (!colsum_plan_ok(N, C, vec, cgt, tiles, blocks, rows_per, fvec))
    return (int)cudaErrorInvalidValue;
  const T* x = (const T*)xv;
  const float n = (float)N;
#define MOMENTS(V_)                                                        \
  switch (pass) {                                                          \
    case kSumsX2:                                                          \
      launch_op(MomentsVec<T, V_, 2>{x}, sums, part, counters, N, C, cgt,  \
                tiles, blocks, rows_per, fvec, s);                         \
      break;                                                               \
    case kSumX:                                                            \
      launch_op(MomentsVec<T, V_, 1>{x}, sums, part, counters, N, C, cgt,  \
                tiles, blocks, rows_per, fvec, s);                         \
      break;                                                               \
    case kSqDev:                                                           \
      launch_op(SqDevVec<T, V_>{x, sums, n}, sums + C, part, counters, N,  \
                C, cgt, tiles, blocks, rows_per, fvec, s);                 \
      break;                                                               \
    default:                                                               \
      return (int)cudaErrorInvalidValue;                                   \
  }
  if (vec == VW) {
    MOMENTS(VW)
  } else {
    MOMENTS(1)
  }
#undef MOMENTS
  return 0;
}
