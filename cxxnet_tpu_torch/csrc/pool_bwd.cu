// Sum / average pooling backward over exactly tiling windows or one
// global window, NHWC.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_pool.py:_pool_bwd_lin_kernel
// (pallas_call in _bwd_call). Same function: every cell of a window gets
// that window's dy, times the avg scale 1/(kh*kw) (rounded to the dtype by
// the caller) with the product rounded to the dtype; for sum the scale is
// 1 and dy is copied. dy is (B, H/kh, W/kw, C), dx (B, H, W, C).
//
// Bound on the H100 (3.35 TB/s): dy read once and dx written once. On the
// training path (global 7x7 average at batch 128, C = 1024, bf16) that is
// 0.26 MB + 12.8 MB, 3.9 us.
//
// Design: one thread per element of dy, neighbouring threads on
// neighbouring channels. A thread reads its dy once, scales it, and writes
// the kh * kw cells of its window: each of those writes is, across a warp,
// one coalesced row of 32 channels. Any batch and window size is taken.
// At the training path's shape: 6.2 us on an H100 80GB HBM3 at 700 W
// (chip_smoke.py).
#include "common.cuh"

template <typename T>
__global__ void pool_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                                int64_t n_out, int H, int W, int C, int kh,
                                int kw, int oy, int ox, float scale,
                                int use_scale) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out;
       o += step) {
    const int c = (int)(o % C);
    int64_t r = o / C;
    const int j = (int)(r % ox);
    r /= ox;
    const int i = (int)(r % oy);
    const int64_t b = r / oy;
    float v = to_f32(dy[o]);
    if (use_scale) v = __fmul_rn(v, scale);
    const T out = from_f32<T>(v);
    T* base = dx + ((b * H + (int64_t)i * kh) * W + (int64_t)j * kw) * C + c;
    for (int u = 0; u < kh; ++u) {
      T* row = base + (int64_t)u * W * C;
      for (int w = 0; w < kw; ++w) row[(int64_t)w * C] = out;
    }
  }
}

template <typename T>
static void launch(const void* dy, void* dx, int64_t n, int H, int W, int C,
                   int kh, int kw, float scale, cudaStream_t s) {
  pool_bwd_kernel<T><<<grid_for(n, 256), 256, 0, s>>>(
      (const T*)dy, (T*)dx, n, H, W, C, kh, kw, H / kh, W / kw, scale,
      scale != 1.0f);
}

// dy: (B, H/kh, W/kw, C), dx: (B, H, W, C), both contiguous of dtype code
// `dtype`. Returns a cudaError_t (0 = launched).
extern "C" int pool_bwd(const void* dy, void* dx, int64_t B, int H, int W,
                        int C, int kh, int kw, int dtype, float scale,
                        void* stream) {
  if (kh <= 0 || kw <= 0 || H % kh || W % kw) return (int)cudaErrorInvalidValue;
  const int64_t n = B * (int64_t)(H / kh) * (W / kw) * C;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: launch<float>(dy, dx, n, H, W, C, kh, kw, scale, s); break;
    case kBF16: launch<__nv_bfloat16>(dy, dx, n, H, W, C, kh, kw, scale, s); break;
    case kF16: launch<__half>(dy, dx, n, H, W, C, kh, kw, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pool_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
