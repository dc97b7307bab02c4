// Bias + activation epilogue backward over (N, C) rows, in one launch.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_epilogue.py:_epi_bwd_kernel
// (pallas_calls in _epi_act_bwd and _epi_bias_bwd). Same function:
// dx = dy, masked to 0 where the forward's output y is not > 0 when the
// relu was folded in; with a bias, dbias = the column sum of that dx in
// f32. dx keeps the dtype of dy. Without the relu dx is dy itself, as in
// the plain version: the wrapper hands dy back and the kernel only reads
// it.
//
// Bound on the H100 (3.35 TB/s): dy (and y, with relu) read once, dx
// written once with relu, dbias written once. AlexNet's cv1 (relu and a
// bias on (774,400, 96) bf16) moves 446 MB, 0.133 ms; Inception-BN's fc1
// (a bias on (128, 1000) bf16, no relu) reads 256 KB, 0.08 us, far below
// one launch, so it is launch-bound there.
//
// Design. With a bias: the one-launch column sums of colsum_vec.cuh with
// the EpiBwdVec op (one sum a channel). A thread loads dy, and y with
// relu, as 16-byte vectors of its V channels, kVecRows rows in flight;
// with relu it stores the masked dx as one 16-byte vector in the op's
// add, after the loads of every row in flight were issued (a store in
// load would hold the next rows' loads behind it). The last CTA of a
// channel tile adds the tile's partials in a fixed order and resets its
// integer arrival counter: reruns agree bit for bit, with no memset and
// no float atomics. The wrapper's plan (ops/fused_epilogue.
// epilogue_bwd_plan) gives each lane kVecRows rows where it can: at a
// fullc's few hundred rows one row block of narrow channel tiles, whose
// CTAs write the sums themselves (no partials, no counter), so the whole
// launch is one round of loads and a reduction in shared memory; at a
// conv's rows, one wave of row blocks. With relu and no bias: a flat
// walk of 16-byte vectors, kEpiRows of each stream in flight a thread,
// one wave of kEpiCtasPerSm CTAs a SM (mask_copy_vec). Where C (or the
// element count) is not a multiple of V or a base is not 16-byte aligned
// the plans take V = 1, one element a load.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py --ab): cv1
// 0.1684 ms, 1.26x its bound, and fc1 2.48 us. The previous design
// (a scalar two-stage column sum writing dx, a finalize kernel, a
// copy of dy without the relu) took 0.2261 ms and 4.26 us there;
// aten.threshold_backward then .sum(0) take 0.2615 ms at cv1, dy.sum(0)
// 3.90 us at fc1.
#include "colsum_vec.cuh"

constexpr int kEpiThreads = 256;
constexpr int kEpiRows = 2;       // vectors of each stream in flight a thread
constexpr int kEpiCtasPerSm = 3;  // resident CTAs a SM the grid fills

// a[k] += dx[k] over V channels a load, dx = dy masked by y > 0 with
// RELU (and then stored), dy itself without
template <typename T, int V_, bool RELU>
struct EpiBwdVec {
  static constexpr int V = V_;
  static constexpr int NS = 1;
  using IO = VecIO<T, V>;
  struct Row {
    typename IO::Raw dy, y;
    int64_t i;
  };
  struct Consts {};
  const T* y;
  const T* dy;
  T* dx;
  __device__ Consts consts(int) const { return Consts{}; }
  __device__ Row load(int64_t i) const {
    Row r;
    r.dy = IO::load(dy + i);
    if (RELU) r.y = IO::load(y + i);
    r.i = i;
    return r;
  }
  __device__ void add(const Row& r, const Consts&, float* a, float*) const {
    typename IO::Raw o = r.dy;
    if (RELU) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (!(IO::at(r.y, j) > 0.f)) o.v[j] = from_f32<T>(0.f);
      // stored here, after the loads of every row in flight were issued
      *reinterpret_cast<typename IO::Raw*>(dx + r.i) = o;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = __fadd_rn(a[j], to_f32(o.v[j]));
  }
};

// dx = dy masked by y > 0 over nv vectors of V elements: thread t takes
// the vectors t, t + stride, ... (stride = the grid's threads)
template <typename T, int V>
__device__ __forceinline__ void mask_store(const typename VecIO<T, V>::Raw& ry,
                                           typename VecIO<T, V>::Raw rd,
                                           T* out) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (!(VecIO<T, V>::at(ry, j) > 0.f)) rd.v[j] = from_f32<T>(0.f);
  *reinterpret_cast<typename VecIO<T, V>::Raw*>(out) = rd;
}

template <typename T, int V>
__global__ void __launch_bounds__(kEpiThreads, kEpiCtasPerSm)
    mask_copy_vec(const T* __restrict__ y, const T* __restrict__ dy,
                  T* __restrict__ dx, int64_t nv) {
  using IO = VecIO<T, V>;
  const int64_t stride = (int64_t)gridDim.x * kEpiThreads;
  int64_t v = (int64_t)blockIdx.x * kEpiThreads + threadIdx.x;
  for (; v + (kEpiRows - 1) * stride < nv; v += kEpiRows * stride) {
    typename IO::Raw rd[kEpiRows], ry[kEpiRows];
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u) {
      rd[u] = IO::load(dy + (v + u * stride) * V);
      ry[u] = IO::load(y + (v + u * stride) * V);
    }
#pragma unroll
    for (int u = 0; u < kEpiRows; ++u)
      mask_store<T, V>(ry[u], rd[u], dx + (v + u * stride) * V);
  }
  for (; v < nv; v += stride)
    mask_store<T, V>(IO::load(y + v * V), IO::load(dy + v * V), dx + v * V);
}

template <typename T, int V, bool RELU>
static void launch_sums(const void* y, const void* dy, void* dx,
                        float* dbias, float* part, unsigned* counters,
                        int64_t N, int C, int cgt, int tiles, int blocks,
                        int64_t rows_per, int fvec, cudaStream_t s) {
  const EpiBwdVec<T, V, RELU> op{(const T*)y, (const T*)dy, (T*)dx};
  colsum_vec<<<dim3(blocks, tiles), kVecThreads, 0, s>>>(
      op, N, C, cgt, rows_per, fvec, part, counters, dbias);
}

template <typename T>
static int run(const void* y, const void* dy, void* dx, float* dbias,
               float* part, unsigned* counters, int64_t N, int C, int vec,
               int cgt, int tiles, int blocks, int64_t rows_per, int fvec,
               int relu, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (relu && (y == nullptr || dx == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool ok16 = aligned16(dy) && (!relu || (aligned16(y) &&
                                                aligned16(dx)));
  if (dbias == nullptr) {         // relu only: the masked copy
    const int64_t n = N * C;
    if (!relu || blocks < 1 || (vec != 1 && (vec != VW || n % VW || !ok16)))
      return (int)cudaErrorInvalidValue;
    if (vec == VW)
      mask_copy_vec<T, VW><<<blocks, kEpiThreads, 0, s>>>(
          (const T*)y, (const T*)dy, (T*)dx, n / VW);
    else
      mask_copy_vec<T, 1><<<blocks, kEpiThreads, 0, s>>>(
          (const T*)y, (const T*)dy, (T*)dx, n);
    return 0;
  }
  if ((vec != 1 && (vec != VW || !ok16)) || part == nullptr ||
      counters == nullptr ||
      !colsum_plan_ok(N, C, vec, cgt, tiles, blocks, rows_per, fvec))
    return (int)cudaErrorInvalidValue;
#define EPI_SUMS(V_, RELU_)                                                 \
  launch_sums<T, V_, RELU_>(y, dy, dx, dbias, part, counters, N, C, cgt,   \
                            tiles, blocks, rows_per, fvec, s)
  if (vec == VW) {
    if (relu) EPI_SUMS(VW, true); else EPI_SUMS(VW, false);
  } else {
    if (relu) EPI_SUMS(1, true); else EPI_SUMS(1, false);
  }
#undef EPI_SUMS
  return 0;
}

// y (the forward's output; read only with relu), dy, dx (written only with
// relu; may be NULL without): (N, C) contiguous of dtype code `dtype`.
// dbias: (C,) f32 output, or NULL for an epilogue with no bias (relu
// only). With dbias: part (blocks * C floats) and counters (`tiles` zero
// unsigned ints, left zero) under ops/fused_epilogue.epilogue_bwd_plan's
// (vec, cgt, tiles, blocks, rows_per, fvec). Without: the masked copy
// under epilogue_copy_plan's (vec, blocks); cgt, tiles, rows_per and fvec
// unused. Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for
// a plan the inputs do not allow).
extern "C" int epilogue_bwd(const void* y, const void* dy, void* dx,
                            float* dbias, float* part, unsigned* counters,
                            int64_t N, int C, int vec, int cgt, int tiles,
                            int blocks, int64_t rows_per, int fvec,
                            int dtype, int relu, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (run<T>(y, dy, dx, dbias, part, counters, N, C, vec,
                               cgt, tiles, blocks, rows_per, fvec, relu, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* epilogue_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
