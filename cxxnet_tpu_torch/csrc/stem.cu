// uint8 decode-normalize: y = (float(x) - mean) * factor, cast once to the
// output dtype.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_stem.py:_stem_kernel (its
// pallas_call in _stem_call). Same function on a uint8 batch viewed as flat
// (B, cols), cols = H*W*C: convert to f32, subtract the mean (none, one per
// channel, or a mean image of H*W*C), multiply by the factor, round once to
// f32, bf16 or f16 (round to nearest even). The subtract and the multiply
// are two f32 roundings (__fsub_rn, __fmul_rn: never contracted or
// reassociated), so the result is bit-equal to the plain version.
//
// Bound on the H100 (3.35 TB/s): bytes. At the Inception-BN train path
// (128 x 224x224x3 uint8 to bf16, a 224x224x3 f32 mean image) the kernel
// reads 19.3 MB and the mean's 0.6 MB and writes 38.5 MB: 17.4 us.
//
// Design: a grid-stride loop over 16-byte vectors of x, one per thread and
// trip: one 16-byte load of x, 16 outputs stored as 16-byte vectors (two for
// bf16/f16, four for f32). The mean is read from its one row (cols or C
// floats, never tiled in memory), indexed by the element's place modulo its
// length, which advances by one per element without a division. Where x or
// y is not 16-byte aligned the loop takes one element per thread, and the
// tail past the last whole vector is done one element per thread. Any B, H,
// W, C is taken: the TPU kernel's block divisibility does not apply.
#include "common.cuh"

template <typename T> struct Vec16;       // 16 outputs as 16-byte words
template <> struct Vec16<float> { uint4 w[4]; };
template <> struct Vec16<__nv_bfloat16> { uint4 w[2]; };
template <> struct Vec16<__half> { uint4 w[2]; };

__device__ __forceinline__ float norm1(uint8_t v, const float* mean, int64_t m,
                                       float f) {
  float y = (float)v;
  if (mean != nullptr) y = __fsub_rn(y, __ldg(mean + m));
  return __fmul_rn(y, f);
}

template <typename T>
__global__ void stem_kernel(const uint8_t* __restrict__ x,
                            const float* __restrict__ mean, int64_t mean_len,
                            float f, T* __restrict__ y, int64_t n,
                            int vector) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vector ? n / 16 : 0;
  for (int64_t v = tid; v < nvec; v += step) {
    const int64_t i0 = v * 16;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + v);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    int64_t m = mean != nullptr ? i0 % mean_len : 0;
    Vec16<T> out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      o[k] = from_f32<T>(norm1(b[k], mean, m, f));
      if (mean != nullptr && ++m == mean_len) m = 0;
    }
    uint4* dst = reinterpret_cast<uint4*>(y + i0);
#pragma unroll
    for (int k = 0; k < (int)(sizeof(Vec16<T>) / 16); ++k) dst[k] = out.w[k];
  }
  for (int64_t i = nvec * 16 + tid; i < n; i += step) {
    y[i] = from_f32<T>(norm1(x[i], mean, mean != nullptr ? i % mean_len : 0,
                             f));
  }
}

template <typename T>
static void launch(const void* x, const void* mean, int64_t mean_len,
                   float f, void* y, int64_t n, cudaStream_t s) {
  const int threads = 256;
  const int vector = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const int64_t items = vector ? n / 16 + n % 16 : n;
  stem_kernel<T><<<grid_for(items, threads), threads, 0, s>>>(
      (const uint8_t*)x, (const float*)mean, mean_len, f, (T*)y, n, vector);
}

// x: n uint8 (B * cols, contiguous); mean: mean_len float32 (C per channel,
// or cols for a mean image; mean_len divides cols) or NULL; y: n of dtype
// code `dtype`. Returns a cudaError_t (0 = launched).
extern "C" int stem(const void* x, const void* mean, int64_t mean_len,
                    float factor, void* y, int64_t n, int dtype,
                    void* stream) {
  if (n < 0 || (mean != nullptr && mean_len <= 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: launch<float>(x, mean, mean_len, factor, y, n, s); break;
    case kBF16: launch<__nv_bfloat16>(x, mean, mean_len, factor, y, n, s); break;
    case kF16: launch<__half>(x, mean, mean_len, factor, y, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
