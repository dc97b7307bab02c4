// The two passes of the batch-norm backward over (N, C) rows, vectorised:
// the column sums SB = sum dy', SXH = sum dy' * x_hat (colsum_vec.cuh's
// one launch, op BwdSumsVec) and the elementwise
//   dx = gamma * rstd * (dy' - SB / N - x_hat * SXH / N),
// with dy' = dy masked by y > 0 when the relu was folded in and
// x_hat = (x - mean) * rstd. bn_bwd (bn_bwd.cu) launches both on one
// device's rows; bn_bwd_sums and bn_bwd_dx (bn_sync.cu) are one each,
// around the all-reduce of the sums.
//
// dx pass (bn_dx_vec). Thread t owns the V = 16 / sizeof(T) neighbouring
// channels of group t % groups (groups = C / V) for its whole loop: the
// per-channel constants gamma * rstd, mean, rstd, SB / N and SXH / N sit
// in registers, loaded once (SB / N and SXH / N divided once a channel
// where the caller hands the sums, __fdiv_rn as the per-element divide of
// the old kernel). It takes the vectors t, t + stride, ... with stride =
// lanes * groups vectors, a multiple of C elements, so the channel group
// never changes: no division in the loop. kDxRows vectors of each stream
// in flight a thread, 16-byte loads of x, dy and y and 16-byte stores of
// dx, one wave of kDxCtasPerSm CTAs a SM. Every multiply and add is a
// rounded f32 operation in the order of the plain version (no FMA
// contraction), so dx is bit-equal to the scalar kernels it replaced.
//
// Mask bits. The relu instance of the sums pass may also write y > 0 as
// bits, one byte a 16-byte vector (bit k for its channel k, V <= 8 bits
// used; a NaN y gives 0, as !(y > 0) does), so that the dx pass reads
// N * C / V bytes in place of y's N * C * sizeof(T).
//
// Where C is not a multiple of V or a base is not 16-byte aligned the
// plans (ops/fused_norm.colsum_vec_plan and bn_dx_plan) take V = 1: one
// element a load, y read as it is. That is a planned path of the same
// kernels.
#pragma once

#include "colsum_vec.cuh"

constexpr int kDxThreads = 256;
constexpr int kDxRows = 2;       // vectors of each stream in flight a thread
constexpr int kDxCtasPerSm = 3;  // resident CTAs a SM the grid fills

// dy' of one element: dy, or 0 where the folded relu's mask is off
__device__ __forceinline__ float relu_grad(float dy, bool on) {
  return on ? dy : 0.f;
}

// bit k: y[k] > 0 (0 for a NaN) of V <= 8 elements
template <typename IO, int V>
__device__ __forceinline__ uint8_t mask_bits(const typename IO::Raw& y) {
  unsigned b = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) b |= (IO::at(y, k) > 0.f ? 1u : 0u) << k;
  return (uint8_t)b;
}

// a[k] += dy'[k], b[k] += dy'[k] * x_hat[k] over V channels a load; with
// BITS also bits[i / V] = the mask of the vector at element i
template <typename T, int V_, bool RELU, bool BITS = false>
struct BwdSumsVec {
  static_assert(!BITS || (RELU && V_ > 1 && V_ <= 8), "mask bits: V <= 8");
  static constexpr int V = V_;
  static constexpr int NS = 2;
  using IO = VecIO<T, V>;
  struct Row {
    typename IO::Raw x, dy, y;
    int64_t i;
  };
  struct Consts {
    float mean[V], rstd[V];
  };
  const T* x;
  const T* dy;
  const T* y;
  const float* mean;
  const float* rstd;
  uint8_t* bits;
  __device__ Consts consts(int c0) const {
    Consts k;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      k.mean[j] = mean[c0 + j];
      k.rstd[j] = rstd[c0 + j];
    }
    return k;
  }
  __device__ Row load(int64_t i) const {
    Row r;
    r.x = IO::load(x + i);
    r.dy = IO::load(dy + i);
    if (RELU) r.y = IO::load(y + i);
    r.i = i;
    return r;
  }
  __device__ void add(const Row& r, const Consts& k, float* a,
                      float* b) const {
    // stored here, after the loads of every row in flight were issued
    if (BITS) bits[r.i / V] = mask_bits<IO, V>(r.y);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = relu_grad(IO::at(r.dy, j),
                                !RELU || IO::at(r.y, j) > 0.f);
      const float xh = __fmul_rn(__fsub_rn(IO::at(r.x, j), k.mean[j]),
                                 k.rstd[j]);
      a[j] = __fadd_rn(a[j], d);
      b[j] = __fadd_rn(b[j], __fmul_rn(d, xh));
    }
  }
};

template <typename T, int V, bool RELU, bool BITS>
static void launch_sums(const void* x, const void* dy, const void* y,
                        uint8_t* bits, const float* mean, const float* rstd,
                        float* sums, float* part, unsigned* counters,
                        int64_t N, int C, int cgt, int tiles, int blocks,
                        int64_t rows_per, int fvec, cudaStream_t s) {
  const BwdSumsVec<T, V, RELU, BITS> op{(const T*)x, (const T*)dy,
                                        (const T*)y, mean, rstd, bits};
  colsum_vec<<<dim3(blocks, tiles), kVecThreads, 0, s>>>(
      op, N, C, cgt, rows_per, fvec, part, counters, sums);
}

// The sums pass under colsum_vec_plan's (vec, cgt, tiles, blocks,
// rows_per, fvec): sums (2, C), row 0 SB and row 1 SXH; part: blocks * 2
// * C floats; counters: `tiles` zero unsigned ints, left zero; bits: NULL,
// or (with y and vec = 16 / sizeof(T)) N * C / vec bytes of mask.
// Returns cudaErrorInvalidValue for a plan the inputs do not allow.
template <typename T>
static int launch_bwd_sums(const void* x, const void* dy, const void* y,
                           uint8_t* bits, const float* mean,
                           const float* rstd, float* sums, float* part,
                           unsigned* counters, int64_t N, int C, int vec,
                           int cgt, int tiles, int blocks, int64_t rows_per,
                           int fvec, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (vec != 1 && (vec != VW || C % VW || !aligned16(x) || !aligned16(dy) ||
                   (y != nullptr && !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  if (!colsum_plan_ok(N, C, vec, cgt, tiles, blocks, rows_per, fvec))
    return (int)cudaErrorInvalidValue;
  if (bits != nullptr && (y == nullptr || vec != VW))
    return (int)cudaErrorInvalidValue;
#define BWD_SUMS(V_, RELU_, BITS_)                                          \
  launch_sums<T, V_, RELU_, BITS_>(x, dy, y, bits, mean, rstd, sums, part, \
                                   counters, N, C, cgt, tiles, blocks,      \
                                   rows_per, fvec, s)
  if (vec == VW) {
    if (bits != nullptr) BWD_SUMS(VW, true, true);
    else if (y != nullptr) BWD_SUMS(VW, true, false);
    else BWD_SUMS(VW, false, false);
  } else {
    if (y != nullptr) BWD_SUMS(1, true, false); else BWD_SUMS(1, false, false);
  }
#undef BWD_SUMS
  return 0;
}

enum DxMask { kNoMask = 0, kMaskY = 1, kMaskBits = 2 };

// The V channels of a vector: dx = g * ((dy' - sb) - x_hat * sxh)
template <typename T, int V, int MASK>
__device__ __forceinline__ void dx_vec(
    const typename VecIO<T, V>::Raw& rx, const typename VecIO<T, V>::Raw& rd,
    const typename VecIO<T, V>::Raw& ry, unsigned rb, const float* km,
    const float* kr, const float* kg, const float* kb, const float* kx,
    T* out) {
  using IO = VecIO<T, V>;
  typename IO::Raw o;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool on = MASK == kNoMask ||
                    (MASK == kMaskY ? IO::at(ry, j) > 0.f : (rb >> j) & 1u);
    const float d = relu_grad(IO::at(rd, j), on);
    const float xh = __fmul_rn(__fsub_rn(IO::at(rx, j), km[j]), kr[j]);
    const float t = __fsub_rn(__fsub_rn(d, kb[j]), __fmul_rn(xh, kx[j]));
    o.v[j] = from_f32<T>(__fmul_rn(kg[j], t));
  }
  *reinterpret_cast<typename IO::Raw*>(out) = o;
}

// nv = N * C / V vectors; thread t < lanes * groups takes the vectors t,
// t + stride, ... (stride = lanes * groups). sb, sxh: (C,) f32, divided
// by `rows` once a channel when rows > 0, taken as SB / N and SXH / N
// when rows == 0.
template <typename T, int V, int MASK>
__global__ void __launch_bounds__(kDxThreads, kDxCtasPerSm)
    bn_dx_vec(const T* __restrict__ x, const T* __restrict__ dy,
              const T* __restrict__ y, const uint8_t* __restrict__ bits,
              const float* __restrict__ gamma, const float* __restrict__ mean,
              const float* __restrict__ rstd, const float* __restrict__ sb,
              const float* __restrict__ sxh, float rows, T* __restrict__ dx,
              int64_t nv, int groups, int64_t lanes) {
  using IO = VecIO<T, V>;
  const int64_t stride = lanes * groups;
  const int64_t t = (int64_t)blockIdx.x * kDxThreads + threadIdx.x;
  if (t >= stride) return;
  const int c0 = (int)(t % groups) * V;
  float km[V], kr[V], kg[V], kb[V], kx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    km[j] = mean[c0 + j];
    kr[j] = rstd[c0 + j];
    kg[j] = __fmul_rn(gamma[c0 + j], kr[j]);
    kb[j] = rows > 0.f ? __fdiv_rn(sb[c0 + j], rows) : sb[c0 + j];
    kx[j] = rows > 0.f ? __fdiv_rn(sxh[c0 + j], rows) : sxh[c0 + j];
  }
  int64_t v = t;
  for (; v + (kDxRows - 1) * stride < nv; v += kDxRows * stride) {
    typename IO::Raw rx[kDxRows], rd[kDxRows], ry[kDxRows];
    unsigned rb[kDxRows];
#pragma unroll
    for (int u = 0; u < kDxRows; ++u) {
      const int64_t i = (v + u * stride) * V;
      rx[u] = IO::load(x + i);
      rd[u] = IO::load(dy + i);
      if (MASK == kMaskY) ry[u] = IO::load(y + i);
      if (MASK == kMaskBits) rb[u] = bits[v + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kDxRows; ++u)
      dx_vec<T, V, MASK>(rx[u], rd[u], ry[u], rb[u], km, kr, kg, kb, kx,
                         dx + (v + u * stride) * V);
  }
  for (; v < nv; v += stride) {
    const int64_t i = v * V;
    typename IO::Raw ry;
    unsigned rb = 0;
    if (MASK == kMaskY) ry = IO::load(y + i);
    if (MASK == kMaskBits) rb = bits[v];
    dx_vec<T, V, MASK>(IO::load(x + i), IO::load(dy + i), ry, rb, km, kr, kg,
                       kb, kx, dx + i);
  }
}

template <typename T, int V, int MASK>
static void launch_dx(const void* x, const void* dy, const void* y,
                      const uint8_t* bits, const float* gamma,
                      const float* mean, const float* rstd, const float* sb,
                      const float* sxh, float rows, void* dx, int64_t nv,
                      int groups, int64_t lanes, int blocks,
                      cudaStream_t s) {
  bn_dx_vec<T, V, MASK><<<blocks, kDxThreads, 0, s>>>(
      (const T*)x, (const T*)dy, (const T*)y, bits, gamma, mean, rstd, sb,
      sxh, rows, (T*)dx, nv, groups, lanes);
}

// The dx pass under bn_dx_plan's (vec, lanes, blocks): y the forward's
// output when the relu was folded in, else NULL; bits NULL, or (with y
// and vec = 16 / sizeof(T)) the sums pass's mask bits, read in place of
// y. Returns cudaErrorInvalidValue for a plan the inputs do not allow.
template <typename T>
static int launch_bn_dx(const void* x, const void* dy, const void* y,
                        const uint8_t* bits, const float* gamma,
                        const float* mean, const float* rstd, const float* sb,
                        const float* sxh, float rows, void* dx, int64_t N,
                        int C, int vec, int64_t lanes, int blocks,
                        cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (vec != 1 && (vec != VW || C % VW || !aligned16(x) || !aligned16(dy) ||
                   !aligned16(dx) || (y != nullptr && !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  const int groups = C / vec;
  if (lanes < 1 || lanes > N || blocks < 1 ||
      (int64_t)blocks * kDxThreads < lanes * groups)
    return (int)cudaErrorInvalidValue;
  if (bits != nullptr && (y == nullptr || vec != VW))
    return (int)cudaErrorInvalidValue;
  const int64_t nv = N * C / vec;
#define BN_DX(V_, MASK_)                                                     \
  launch_dx<T, V_, MASK_>(x, dy, y, bits, gamma, mean, rstd, sb, sxh, rows, \
                          dx, nv, groups, lanes, blocks, s)
  if (vec == VW) {
    if (bits != nullptr) BN_DX(VW, kMaskBits);
    else if (y != nullptr) BN_DX(VW, kMaskY);
    else BN_DX(VW, kNoMask);
  } else {
    if (y != nullptr) BN_DX(1, kMaskY); else BN_DX(1, kNoMask);
  }
#undef BN_DX
  return 0;
}
