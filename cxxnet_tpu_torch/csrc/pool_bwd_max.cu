// First-match max pooling backward over exactly tiling windows or one
// global window, NHWC.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_pool.py:_pool_bwd_max_kernel
// (pallas_call in _bwd_call). Same function: for each output cell
// (b, oy, ox, c), the first cell of its kh x kw window in row-major order
// whose value equals the window's max y takes the whole dy; every other
// cell gets 0. With pre_relu (relu_max_pooling) the cells are relu(x) and
// a cell counts only if x > 0, so a window of non-positive values passes
// nothing. XLA's select-and-scatter has the same semantics. A NaN max
// matches no cell. x and dx are (B, H, W, C), y and dy (B, H/kh, W/kw, C).
//
// Bound on the H100 (3.35 TB/s): bytes, x, y and dy read once and dx
// written once. At the SPP net's spp1 (x (128, 27, 27, 256), 3x3/3,
// bf16) that is 47.8 + 5.3 + 5.3 + 47.8 MB, 31.7 us.
//
// Design: one thread per output cell, neighbouring threads on
// neighbouring channels. A thread reads its y and dy once, sweeps its
// window reading x (each step a coalesced row of C across the warp), and
// writes every dx cell of the window exactly once: no atomics and no
// zero fill beforehand. No cap on the window size: the TPU kernel's
// 16-cell limit was its unrolling budget, so a 7x7 global max takes the
// kernel too.
#include "common.cuh"

template <typename T>
__global__ void pool_bwd_max_kernel(const T* __restrict__ x,
                                    const T* __restrict__ y,
                                    const T* __restrict__ dy,
                                    T* __restrict__ dx, int64_t n_out, int H,
                                    int W, int C, int kh, int kw, int oy,
                                    int ox, int pre_relu) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const T zero = from_f32<T>(0.f);
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out;
       o += step) {
    const int c = (int)(o % C);
    int64_t r = o / C;
    const int j = (int)(r % ox);
    r /= ox;
    const int i = (int)(r % oy);
    const int64_t b = r / oy;
    const float ym = to_f32(y[o]);
    const T g = dy[o];
    const int64_t base = ((b * H + (int64_t)i * kh) * W + (int64_t)j * kw) * C + c;
    bool taken = false;
    for (int u = 0; u < kh; ++u) {
      const int64_t rowoff = base + (int64_t)u * W * C;
      for (int w = 0; w < kw; ++w) {
        const int64_t off = rowoff + (int64_t)w * C;
        const float v = to_f32(x[off]);
        const float va = pre_relu ? relu_f32(v) : v;
        const bool hit = !taken && va == ym && (!pre_relu || v > 0.f);
        taken = taken || hit;
        dx[off] = hit ? g : zero;
      }
    }
  }
}

template <typename T>
static void launch(const void* x, const void* y, const void* dy, void* dx,
                   int64_t n, int H, int W, int C, int kh, int kw,
                   int pre_relu, cudaStream_t s) {
  pool_bwd_max_kernel<T><<<grid_for(n, 256), 256, 0, s>>>(
      (const T*)x, (const T*)y, (const T*)dy, (T*)dx, n, H, W, C, kh, kw,
      H / kh, W / kw, pre_relu);
}

// x, dx: (B, H, W, C); y, dy: (B, H/kh, W/kw, C); all contiguous of dtype
// code `dtype`. Returns a cudaError_t (0 = launched).
extern "C" int pool_bwd_max(const void* x, const void* y, const void* dy,
                            void* dx, int64_t B, int H, int W, int C, int kh,
                            int kw, int dtype, int pre_relu, void* stream) {
  if (kh <= 0 || kw <= 0 || H % kh || W % kw) return (int)cudaErrorInvalidValue;
  const int64_t n = B * (int64_t)(H / kh) * (W / kw) * C;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: launch<float>(x, y, dy, dx, n, H, W, C, kh, kw, pre_relu, s); break;
    case kBF16: launch<__nv_bfloat16>(x, y, dy, dx, n, H, W, C, kh, kw, pre_relu, s); break;
    case kF16: launch<__half>(x, y, dy, dx, n, H, W, C, kh, kw, pre_relu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pool_bwd_max_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
