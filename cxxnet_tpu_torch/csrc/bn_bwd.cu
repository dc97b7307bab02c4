// Batch-norm backward with an optional folded relu, over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_norm.py:_bn_bwd_kernel
// (pallas_call in _bn_backward). Same function: with dy' = dy, masked by
// y > 0 when the relu was folded in, and x_hat = (x - mean) * rstd,
//   dbeta  = sum over rows of dy'          (f32, per channel)
//   dgamma = sum over rows of dy' * x_hat  (f32, per channel)
//   dx = gamma * rstd * (dy' - dbeta / N - x_hat * (dgamma / N)),
// rounded to the dtype of x. The gradients that mean and var receive are
// dropped (they feed the running-statistic EMA only).
//
// Bound on the H100 (3.35 TB/s): the bytes that must move, x, dy and (with
// relu) y read once and dx written once, 4 * N * C * sizeof(T) with relu,
// 3 * N * C * sizeof(T) without. For bn_stem1 at batch 128 (N * C =
// 128 * 112 * 112 * 64, bf16) with relu that is 822 MB, 0.245 ms.
//
// Design: the two-stage column sums of colsum.cuh for the two reductions
// (one read of x, dy and y), a finalize kernel that adds the partials in a
// fixed order into dgamma and dbeta, and a dx sweep that reads x, dy and y
// again: 7 * N * C * sizeof(T) of traffic with relu. No atomics: repeated
// runs agree bit for bit. The dx formula uses rounded f32 operations in
// the order of the plain version (no contraction into an FMA). At
// bn_stem1: 0.73 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py).
#include "colsum.cuh"

template <typename T>
__device__ __forceinline__ float masked_dy(const T* dy, const T* y,
                                           int64_t i) {
  const float d = to_f32(dy[i]);
  if (y != nullptr && !(to_f32(y[i]) > 0.f)) return 0.f;
  return d;
}

template <typename T>
struct GradSums {  // a += dy', b += dy' * x_hat
  const T* x;
  const T* dy;
  const T* y;
  const float* mean;
  const float* rstd;
  __device__ void operator()(int64_t i, int c, float& a, float& b) const {
    const float d = masked_dy(dy, y, i);
    const float xh = __fmul_rn(__fsub_rn(to_f32(x[i]), mean[c]), rstd[c]);
    a += d;
    b += d * xh;
  }
};

__global__ void finalize_grads(const float* __restrict__ p1,
                               const float* __restrict__ p2, int G, int C,
                               float* dgamma, float* dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  dbeta[c] = sum_partials(p1, G, C, c);
  dgamma[c] = sum_partials(p2, G, C, c);
}

template <typename T>
__global__ void bn_dx(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ y,
                      const float* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const float* __restrict__ dgamma,
                      const float* __restrict__ dbeta, T* __restrict__ dx,
                      int64_t n, int C, float rows) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)(i % C);
    const float d = masked_dy(dy, y, i);
    const float xh = __fmul_rn(__fsub_rn(to_f32(x[i]), mean[c]), rstd[c]);
    const float g = __fmul_rn(gamma[c], rstd[c]);
    const float t = __fsub_rn(__fsub_rn(d, __fdiv_rn(dbeta[c], rows)),
                              __fmul_rn(xh, __fdiv_rn(dgamma[c], rows)));
    dx[i] = from_f32<T>(__fmul_rn(g, t));
  }
}

template <typename T>
static void run(const void* x, const void* dy, const void* y,
                const float* gamma, const float* mean, const float* rstd,
                void* dx, float* dgamma, float* dbeta, float* part,
                int64_t N, int C, int G, cudaStream_t s) {
  float* p1 = part;
  float* p2 = part + (int64_t)G * C;
  GradSums<T> op{(const T*)x, (const T*)dy, (const T*)y, mean, rstd};
  launch_colsum(op, N, C, G, p1, p2, s);
  finalize_grads<<<(C + 255) / 256, 256, 0, s>>>(p1, p2, G, C, dgamma, dbeta);
  const int64_t total = N * C;
  bn_dx<T><<<grid_for(total, 256), 256, 0, s>>>(
      (const T*)x, (const T*)dy, (const T*)y, gamma, mean, rstd, dgamma,
      dbeta, (T*)dx, total, C, (float)N);
}

// x, dy, dx: (N, C) contiguous of dtype code `dtype`; y: the forward's
// output (N, C) when the relu was folded in, else NULL; gamma, mean, rstd:
// (C,) f32; dgamma, dbeta: (C,) f32 outputs; part: 2 * G * C f32 scratch.
// Returns a cudaError_t (0 = launched).
extern "C" int bn_bwd(const void* x, const void* dy, const void* y,
                      const float* gamma, const float* mean,
                      const float* rstd, void* dx, float* dgamma,
                      float* dbeta, float* part, int64_t N, int C, int G,
                      int dtype, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: run<float>(x, dy, y, gamma, mean, rstd, dx, dgamma, dbeta, part, N, C, G, s); break;
    case kBF16: run<__nv_bfloat16>(x, dy, y, gamma, mean, rstd, dx, dgamma, dbeta, part, N, C, G, s); break;
    case kF16: run<__half>(x, dy, y, gamma, mean, rstd, dx, dgamma, dbeta, part, N, C, G, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
