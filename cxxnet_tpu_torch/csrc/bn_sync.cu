// Synchronized (cross-rank) batch norm with an optional folded relu, over
// (N, C) rows: the four per-rank passes around the two all-reduces.
//
// Replaces the TPU kernels of the dp-mesh island in
// cxxnet_tpu/ops/fused_norm.py (pallas_calls in _mesh_fwd_local and
// _mesh_bwd_local):
//   bn_sums      <- _bn_sums_kernel:     S1 = sum x, S2 = sum x^2 (f32)
//   bn_norm      <- _bn_norm_kernel:     y = (x - mean) * rstd * gamma + beta
//                                        (+ relu), y in the dtype of x
//   bn_bwd_sums  <- _bn_bwd_sums_kernel: SB = sum dy', SXH = sum dy' * x_hat
//   bn_bwd_dx    <- _bn_bwd_dx_kernel:   dx = gamma * rstd *
//                                        (dy' - SB/N - x_hat * SXH/N)
// with dy' = dy masked by y > 0 when the relu was folded in and
// x_hat = (x - mean) * rstd. The sums are the rank's own; the caller
// all-reduces them and hands the global mean, rstd and SB/N, SXH/N back
// in as (C,) f32 vectors, as the TPU island's psum did.
//
// Bound on the H100 (3.35 TB/s): the bytes that must move. bn_sums reads x
// once (N * C * sizeof(T)); bn_norm reads x and writes y (2x); bn_bwd_sums
// reads x, dy and, with relu, y (3x); bn_bwd_dx reads those and writes dx
// (4x). Operations are a handful per element, far below the f32 rate.
//
// Design: bn_sums takes the two-stage column sums of colsum.cuh (a grid of
// row-block CTAs, each thread one channel of a coalesced row read; the
// partials added per channel in a fixed order by a finalize kernel);
// bn_bwd_sums the one-launch vectorised column sums of colsum_vec.cuh
// (16-byte loads, the last CTA adds the partials). Both add in a fixed
// order, so two runs on the same input agree bit for bit and so do both
// ranks' reductions of the same rows. They write into one (2, C) f32
// buffer, the buffer the caller all-reduces in one call. The elementwise
// passes are grid-stride loops; every multiply and add is a rounded f32
// operation in the order of the plain PyTorch version (no contraction
// into an FMA). Any N and C: the TPU kernel's row-block divisibility does
// not apply.
#include "colsum.cuh"
#include "colsum_vec.cuh"

template <typename T>
struct Moments {  // a += x, b += x * x
  const T* x;
  __device__ void operator()(int64_t i, int, float& a, float& b) const {
    const float v = to_f32(x[i]);
    a += v;
    b += __fmul_rn(v, v);
  }
};

template <typename T>
__device__ __forceinline__ float masked_grad(const T* dy, const T* y,
                                             int64_t i) {
  const float d = to_f32(dy[i]);
  if (y != nullptr && !(to_f32(y[i]) > 0.f)) return 0.f;
  return d;
}

// a[k] += dy'[k], b[k] += dy'[k] * x_hat[k] over V channels a load
template <typename T, int V_, bool RELU>
struct BwdSumsVec {
  static constexpr int V = V_;
  using IO = VecIO<T, V>;
  struct Row {
    typename IO::Raw x, dy, y;
  };
  struct Consts {
    float mean[V], rstd[V];
  };
  const T* x;
  const T* dy;
  const T* y;
  const float* mean;
  const float* rstd;
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
    return r;
  }
  __device__ void add(const Row& r, const Consts& k, float* a,
                      float* b) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float d = IO::at(r.dy, j);
      if (RELU && !(IO::at(r.y, j) > 0.f)) d = 0.f;
      const float xh = __fmul_rn(__fsub_rn(IO::at(r.x, j), k.mean[j]),
                                 k.rstd[j]);
      a[j] = __fadd_rn(a[j], d);
      b[j] = __fadd_rn(b[j], __fmul_rn(d, xh));
    }
  }
};

// out[c] = sum of p1's partials, out[C + c] = sum of p2's, in row-block order
__global__ void finalize_pair(const float* __restrict__ p1,
                              const float* __restrict__ p2, int G, int C,
                              float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  out[c] = sum_partials(p1, G, C, c);
  out[C + c] = sum_partials(p2, G, C, c);
}

template <typename T>
__global__ void sync_normalize(const T* __restrict__ x,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               T* __restrict__ y, int64_t n, int C,
                               int relu) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)(i % C);
    float v = __fmul_rn(__fsub_rn(to_f32(x[i]), mean[c]), rstd[c]);
    v = __fadd_rn(__fmul_rn(v, gamma[c]), beta[c]);
    if (relu) v = relu_f32(v);
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
__global__ void sync_dx(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ y,
                        const float* __restrict__ gamma,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ sbn,
                        const float* __restrict__ sxhn, T* __restrict__ dx,
                        int64_t n, int C) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)(i % C);
    const float d = masked_grad(dy, y, i);
    const float xh = __fmul_rn(__fsub_rn(to_f32(x[i]), mean[c]), rstd[c]);
    const float g = __fmul_rn(gamma[c], rstd[c]);
    const float t = __fsub_rn(__fsub_rn(d, sbn[c]), __fmul_rn(xh, sxhn[c]));
    dx[i] = from_f32<T>(__fmul_rn(g, t));
  }
}

// runs the statement(s) with T the element type of dtype code `dtype`
#define DISPATCH(dtype, ...)                                       \
  switch (dtype) {                                                 \
    case kF32: { using T = float; __VA_ARGS__; } break;            \
    case kBF16: { using T = __nv_bfloat16; __VA_ARGS__; } break;   \
    case kF16: { using T = __half; __VA_ARGS__; } break;           \
    default: return (int)cudaErrorInvalidValue;                    \
  }

// x: (N, C) of dtype code `dtype`; sums: (2, C) f32 output, row 0 S1 and
// row 1 S2; part: 2 * G * C f32 scratch. Returns a cudaError_t.
extern "C" int bn_sums(const void* x, float* sums, float* part, int64_t N,
                       int C, int G, int dtype, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p1 = part;
  float* p2 = part + (int64_t)G * C;
  DISPATCH(dtype, launch_colsum(Moments<T>{(const T*)x}, N, C, G, p1, p2, s));
  finalize_pair<<<(C + 255) / 256, 256, 0, s>>>(p1, p2, G, C, sums);
  return (int)cudaGetLastError();
}

// x, y: (N, C) of dtype code `dtype`; gamma, beta, mean, rstd: (C,) f32.
extern "C" int bn_norm(const void* x, const float* gamma, const float* beta,
                       const float* mean, const float* rstd, void* y,
                       int64_t N, int C, int dtype, int relu, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = N * C;
  DISPATCH(dtype, sync_normalize<T><<<grid_for(total, 256), 256, 0, s>>>(
                      (const T*)x, gamma, beta, mean, rstd, (T*)y, total, C,
                      relu));
  return (int)cudaGetLastError();
}

template <typename T, int V, bool RELU>
static void launch_bwd_sums(const void* x, const void* dy, const void* y,
                            const float* mean, const float* rstd, float* sums,
                            float* part, unsigned* counters, int64_t N, int C,
                            int cgt, int tiles, int blocks, int64_t rows_per,
                            int fvec, cudaStream_t s) {
  const BwdSumsVec<T, V, RELU> op{(const T*)x, (const T*)dy, (const T*)y,
                                  mean, rstd};
  colsum_vec<<<dim3(blocks, tiles), kVecThreads, 0, s>>>(
      op, N, C, cgt, rows_per, fvec, part, counters, sums);
}

template <typename T>
static int bwd_sums_typed(const void* x, const void* dy, const void* y,
                          const float* mean, const float* rstd, float* sums,
                          float* part, unsigned* counters, int64_t N, int C,
                          int vec, int cgt, int tiles, int blocks,
                          int64_t rows_per, int fvec, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const int groups = vec == VW ? C / VW : C;
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  if (vec != 1 && (vec != VW || C % VW || !aligned(x) || !aligned(dy) ||
                   (y != nullptr && !aligned(y))))
    return (int)cudaErrorInvalidValue;
  if (cgt < 1 || cgt > kVecThreads || tiles != (groups + cgt - 1) / cgt ||
      blocks < 1 || rows_per < 1 || (int64_t)blocks * rows_per < N ||
      (fvec != 1 && (fvec != 4 || C % 4 || (cgt * vec) % 4)))
    return (int)cudaErrorInvalidValue;
#define BWD_SUMS(V_, RELU_)                                                 \
  launch_bwd_sums<T, V_, RELU_>(x, dy, y, mean, rstd, sums, part, counters, \
                                N, C, cgt, tiles, blocks, rows_per, fvec, s)
  if (vec == VW) {
    if (y != nullptr) BWD_SUMS(VW, true); else BWD_SUMS(VW, false);
  } else {
    if (y != nullptr) BWD_SUMS(1, true); else BWD_SUMS(1, false);
  }
#undef BWD_SUMS
  return 0;
}

// x, dy: (N, C) of dtype code `dtype`; y: the forward's output when the
// relu was folded in, else NULL; mean, rstd: (C,) f32; sums: (2, C) f32
// output, row 0 SB and row 1 SXH; part: blocks * 2 * C f32 scratch;
// counters: `tiles` zero unsigned ints, left zero. vec, cgt, tiles,
// blocks, rows_per, fvec: ops/fused_norm.colsum_vec_plan. Returns a
// cudaError_t.
extern "C" int bn_bwd_sums(const void* x, const void* dy, const void* y,
                           const float* mean, const float* rstd, float* sums,
                           float* part, unsigned* counters, int64_t N, int C,
                           int vec, int cgt, int tiles, int blocks,
                           int64_t rows_per, int fvec, int dtype,
                           void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = bwd_sums_typed<T>(x, dy, y, mean, rstd, sums, part,
                                         counters, N, C, vec, cgt, tiles,
                                         blocks, rows_per, fvec, s));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// x, dy, dx: (N, C) of dtype code `dtype`; y as for bn_bwd_sums; gamma,
// mean, rstd and the global SB / N_global (sbn) and SXH / N_global (sxhn):
// (C,) f32.
extern "C" int bn_bwd_dx(const void* x, const void* dy, const void* y,
                         const float* gamma, const float* mean,
                         const float* rstd, const float* sbn,
                         const float* sxhn, void* dx, int64_t N, int C,
                         int dtype, void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = N * C;
  DISPATCH(dtype, sync_dx<T><<<grid_for(total, 256), 256, 0, s>>>(
                      (const T*)x, (const T*)dy, (const T*)y, gamma, mean,
                      rstd, sbn, sxhn, (T*)dx, total, C));
  return (int)cudaGetLastError();
}

extern "C" const char* bn_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_bwd_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
extern "C" const char* bn_bwd_dx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
