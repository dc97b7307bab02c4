// Shared helpers of the port's hand-written kernels: dtype codes (as the
// Python wrappers pass them), conversions through float, vectors of V
// elements loaded as one instruction, and the launch grid of a
// grid-stride loop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with cxxnet_tpu_torch/ops/fused.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T (round to nearest even) and widened back to float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// V elements of T, loaded and stored as one vector of sizeof(T) * V bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) VecOf {
  T v[V];
};

template <typename T, int V>
struct VecIO {
  using Raw = VecOf<T, V>;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ float at(const Raw& r, int k) {
    return to_f32(r.v[k]);
  }
};

// relu that lets a NaN through, as jnp.maximum(x, 0) and torch.relu do
__device__ __forceinline__ float relu_f32(float v) { return (v > 0.f || v != v) ? v : 0.f; }

// blocks for a grid-stride loop over n items: one item per thread up to a
// cap that still keeps every SM busy
static inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  return (int)(blocks < cap ? blocks : cap);
}
