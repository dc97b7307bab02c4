// Batch-norm forward with an optional folded relu, over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_norm.py:_bn_fwd_kernel
// (pallas_call in _bn_forward). Same function: per-channel moments of x
// over its N = B*H*W rows in f32 -- one-pass E[x^2] - E[x]^2 clamped at
// 0, or with two_pass the mean first and then E[(x - mean)^2] -- then
// y = ((x - mean) * rstd) * gamma + beta, rstd = rsqrt(var + eps), an
// optional relu, and y rounded to the dtype of x. mean, var and rstd come
// out in f32 (the running-statistic EMA reads mean and var, the backward
// mean and rstd).
//
// Bound on the H100 (3.35 TB/s): the bytes that must move, x read once
// and y written once, 2 * N * C * sizeof(T). For bn_stem1 at batch 128
// (N * C = 128 * 112 * 112 * 64, bf16) that is 411 MB, 0.123 ms.
//
// Design: two stages instead of the TPU's sequential grid that carried
// the sums in VMEM from one row block to the next. Stage 1 is a grid of
// row-block CTAs writing f32 partial sums per channel (colsum.cuh, one
// coalesced read of x); a finalize kernel adds the partials in a fixed
// order and forms mean, var and rstd; a normalize sweep reads x again
// and writes y. So the design moves 3 * N * C * sizeof(T) (0.18 ms of
// traffic at bn_stem1), 4 with two_pass. No atomics: repeated runs agree
// bit for bit. The normalize's multiply and add are the rounded f32
// operations of the plain version (no contraction into an FMA). At
// bn_stem1: 0.41 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py).
#include "colsum.cuh"

template <typename T>
struct SumSq {  // a += x, b += x * x
  const T* x;
  __device__ void operator()(int64_t i, int, float& a, float& b) const {
    const float v = to_f32(x[i]);
    a += v;
    b += v * v;
  }
};

template <typename T>
struct SqDev {  // a += (x - mean)^2
  const T* x;
  const float* mean;
  __device__ void operator()(int64_t i, int c, float& a, float&) const {
    const float d = to_f32(x[i]) - mean[c];
    a += d * d;
  }
};

// one pass: mean = S1 / N, var = max(S2 / N - mean^2, 0)
__global__ void finalize_one_pass(const float* __restrict__ p1,
                                  const float* __restrict__ p2, int G, int C,
                                  float n, float eps, float* mean, float* var,
                                  float* rstd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float m = sum_partials(p1, G, C, c) / n;
  const float v = fmaxf(sum_partials(p2, G, C, c) / n - m * m, 0.f);
  mean[c] = m;
  var[c] = v;
  rstd[c] = rsqrtf(v + eps);
}

// two pass, first half: mean = S1 / N
__global__ void finalize_mean(const float* __restrict__ p1, int G, int C,
                              float n, float* mean) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) mean[c] = sum_partials(p1, G, C, c) / n;
}

// two pass, second half: var = S2 / N where S2 = sum (x - mean)^2
__global__ void finalize_var(const float* __restrict__ p2, int G, int C,
                             float n, float eps, float* var, float* rstd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float v = sum_partials(p2, G, C, c) / n;
  var[c] = v;
  rstd[c] = rsqrtf(v + eps);
}

template <typename T>
__global__ void bn_normalize(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             T* __restrict__ y, int64_t n, int C, int relu) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)(i % C);
    float v = __fsub_rn(to_f32(x[i]), mean[c]);
    v = __fadd_rn(__fmul_rn(__fmul_rn(v, rstd[c]), gamma[c]), beta[c]);
    if (relu) v = relu_f32(v);
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
static void run(const void* xv, const float* gamma, const float* beta,
                void* yv, float* mean, float* var, float* rstd, float* part,
                int64_t N, int C, int G, int relu, int two_pass, float eps,
                cudaStream_t s) {
  const T* x = (const T*)xv;
  float* p1 = part;
  float* p2 = part + (int64_t)G * C;
  const int fin_blocks = (C + 255) / 256;
  const float n = (float)N;
  if (two_pass) {
    launch_colsum(SumSq<T>{x}, N, C, G, p1, nullptr, s);
    finalize_mean<<<fin_blocks, 256, 0, s>>>(p1, G, C, n, mean);
    launch_colsum(SqDev<T>{x, mean}, N, C, G, p2, nullptr, s);
    finalize_var<<<fin_blocks, 256, 0, s>>>(p2, G, C, n, eps, var, rstd);
  } else {
    launch_colsum(SumSq<T>{x}, N, C, G, p1, p2, s);
    finalize_one_pass<<<fin_blocks, 256, 0, s>>>(p1, p2, G, C, n, eps, mean,
                                                 var, rstd);
  }
  const int64_t total = N * C;
  bn_normalize<T><<<grid_for(total, 256), 256, 0, s>>>(
      x, gamma, beta, mean, rstd, (T*)yv, total, C, relu);
}

// x, y: (N, C) contiguous of dtype code `dtype`; gamma, beta: (C,) f32;
// mean, var, rstd: (C,) f32 outputs; part: 2 * G * C f32 scratch. G is the
// number of row blocks of stage 1 (chosen by the caller). Returns a
// cudaError_t (0 = launched).
extern "C" int bn_fwd(const void* x, const float* gamma, const float* beta,
                      void* y, float* mean, float* var, float* rstd,
                      float* part, int64_t N, int C, int G, int dtype,
                      int relu, int two_pass, float eps, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: run<float>(x, gamma, beta, y, mean, var, rstd, part, N, C, G, relu, two_pass, eps, s); break;
    case kBF16: run<__nv_bfloat16>(x, gamma, beta, y, mean, var, rstd, part, N, C, G, relu, two_pass, eps, s); break;
    case kF16: run<__half>(x, gamma, beta, y, mean, var, rstd, part, N, C, G, relu, two_pass, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
