// The batch-norm normalize over (N, C) rows, vectorised:
//   y = ((x - mean) * rstd) * gamma + beta   (+ relu), in the dtype of x,
// with the moments and the affine parameters handed in as (C,) f32
// vectors. bn_norm (bn_sync.cu) launches it with the all-reduced moments;
// bn_fwd (bn_fwd.cu) takes the same walk (norm_walk) in its own kernel,
// which forms the moments from the column sums, and epilogue_fwd
// (epilogue_fwd.cu) takes it with its bias-and-relu op.
//
// The walk is the dx pass's (bn_bwd_vec.cuh's bn_dx_vec). Thread t owns
// the V = 16 / sizeof(T) neighbouring channels of group t % groups
// (groups = C / V) for its whole loop: their constants (here mean, rstd,
// gamma and beta) sit in registers in the walk's op, loaded once. It takes
// the vectors t, t + stride, ... with stride = lanes * groups vectors, a
// multiple of C elements, so the channel group never changes: no division
// in the loop. kNormRows vectors of x in flight a thread, 16-byte loads of
// x and 16-byte stores of y, one wave of kNormCtasPerSm CTAs a SM
// (ops/fused_norm.bn_dx_plan plans both walks: kNormThreads and
// kNormCtasPerSm are the dx pass's). The op maps channel j of the group
// (0 <= j < V) from f32 to f32; the walk rounds its result to T. The
// walk's index type I is the caller's: 64-bit for the BN kernels, 32-bit
// for the epilogue, which launches its rows in slices to stay below 2^31.
// Every operation of NormOp is a rounded f32 operation in the order of the
// plain version (no FMA contraction), so y is bit-equal to it on finite
// inputs.
//
// Where C is not a multiple of V or a base is not 16-byte aligned the plan
// takes V = 1: one element a load, a planned path of the same kernel.
#pragma once

#include "colsum_vec.cuh"

constexpr int kNormThreads = 256;
constexpr int kNormRows = 2;       // vectors of x in flight a thread
constexpr int kNormCtasPerSm = 3;  // resident CTAs a SM the grid fills

// The normalize of channel j of a group: ((x - mean) * rstd) * gamma +
// beta (+ relu), the group's constants in registers
template <int V, bool RELU>
struct NormOp {
  float km[V], kr[V], kg[V], kb[V];
  __device__ __forceinline__ float operator()(float x, int j) const {
    const float v = __fmul_rn(__fsub_rn(x, km[j]), kr[j]);
    const float o = __fadd_rn(__fmul_rn(v, kg[j]), kb[j]);
    return RELU ? relu_f32(o) : o;
  }
};

// The V channels of a vector through op, rounded to T and stored at out
template <typename T, int V, typename Op>
__device__ __forceinline__ void op_vec(const typename VecIO<T, V>::Raw& rx,
                                       const Op& op, T* out) {
  using IO = VecIO<T, V>;
  typename IO::Raw o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(op(IO::at(rx, j), j));
  *reinterpret_cast<typename IO::Raw*>(out) = o;
}

// Thread t's walk: the vectors t, t + stride, ... below nv, kNormRows
// in flight, each through op (its channel group's)
template <typename T, int V, typename Op, typename I>
__device__ __forceinline__ void norm_walk(const T* __restrict__ x,
                                          T* __restrict__ y, I t, I stride,
                                          I nv, const Op& op) {
  using IO = VecIO<T, V>;
  I v = t;
  for (; v + (kNormRows - 1) * stride < nv; v += kNormRows * stride) {
    typename IO::Raw rx[kNormRows];
#pragma unroll
    for (int u = 0; u < kNormRows; ++u) rx[u] = IO::load(x + (v + u * stride) * V);
#pragma unroll
    for (int u = 0; u < kNormRows; ++u)
      op_vec<T, V>(rx[u], op, y + (v + u * stride) * V);
  }
  for (; v < nv; v += stride) op_vec<T, V>(IO::load(x + v * V), op, y + v * V);
}

// nv = N * C / V vectors; thread t < lanes * groups takes the vectors t,
// t + stride, ... (stride = lanes * groups)
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kNormThreads, kNormCtasPerSm)
    bn_norm_vec(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ y,
                int64_t nv, int groups, int64_t lanes) {
  const int64_t stride = lanes * groups;
  const int64_t t = (int64_t)blockIdx.x * kNormThreads + threadIdx.x;
  if (t >= stride) return;
  const int c0 = (int)(t % groups) * V;
  NormOp<V, RELU> op;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    op.km[j] = mean[c0 + j];
    op.kr[j] = rstd[c0 + j];
    op.kg[j] = gamma[c0 + j];
    op.kb[j] = beta[c0 + j];
  }
  norm_walk<T, V>(x, y, t, stride, nv, op);
}

// Whether bn_dx_plan's (vec, lanes, blocks) covers (N, C) rows of T from
// x to y: 16-byte loads only where C and both bases allow them, lanes
// threads of each of the C / vec channel groups on `blocks` CTAs
template <typename T>
static bool norm_plan_ok(const void* x, const void* y, int64_t N, int C,
                         int vec, int64_t lanes, int blocks) {
  constexpr int VW = 16 / sizeof(T);
  if (vec != 1 && (vec != VW || C % VW || !aligned16(x) || !aligned16(y)))
    return false;
  return lanes >= 1 && lanes <= N && blocks >= 1 &&
         (int64_t)blocks * kNormThreads >= lanes * (C / vec);
}

template <typename T, int V, bool RELU>
static void launch_norm(const void* x, const float* gamma, const float* beta,
                        const float* mean, const float* rstd, void* y,
                        int64_t nv, int groups, int64_t lanes, int blocks,
                        cudaStream_t s) {
  bn_norm_vec<T, V, RELU><<<blocks, kNormThreads, 0, s>>>(
      (const T*)x, gamma, beta, mean, rstd, (T*)y, nv, groups, lanes);
}

// The normalize under bn_dx_plan's (vec, lanes, blocks). Returns
// cudaErrorInvalidValue for a plan the inputs do not allow.
template <typename T>
static int launch_bn_norm(const void* x, const float* gamma,
                          const float* beta, const float* mean,
                          const float* rstd, void* y, int64_t N, int C,
                          int vec, int64_t lanes, int blocks, int relu,
                          cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (!norm_plan_ok<T>(x, y, N, C, vec, lanes, blocks))
    return (int)cudaErrorInvalidValue;
  const int groups = C / vec;
  const int64_t nv = N * C / vec;
#define BN_NORM(V_, RELU_)                                                \
  launch_norm<T, V_, RELU_>(x, gamma, beta, mean, rstd, y, nv, groups,   \
                            lanes, blocks, s)
  if (vec == VW) {
    if (relu) BN_NORM(VW, true); else BN_NORM(VW, false);
  } else {
    if (relu) BN_NORM(1, true); else BN_NORM(1, false);
  }
#undef BN_NORM
  return 0;
}
