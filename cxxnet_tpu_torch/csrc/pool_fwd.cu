// Pooling forward over exactly tiling windows or one global window, NHWC.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_pool.py:_pool_fwd_kernel
// (pallas_call in _fwd_call). Same function: max or sum over each
// kh x kw window of x (B, H, W, C), where the windows either tile H x W
// exactly (stride == window, no padding) or cover it whole; optional
// relu on the inputs first; for avg the window sum is rounded to the
// input dtype and multiplied by the scale 1/(kh*kw), itself rounded to
// the input dtype by the caller (fused_pool.py:86-88). In max a NaN wins
// and stays.
//
// Bound on the H100 (3.35 TB/s): the bytes moved, each input read once and
// each output written once. On the training path (global 7x7 average over
// (128, 7, 7, 1024) bf16) that is 12.8 MB, 3.91 us.
//
// The first design (one thread an output channel, a loop over its window
// with scalar 2-byte loads strided by C, its 49 loads a dependent chain)
// took 9.23 us there on an NVIDIA H100 80GB HBM3 at 700 W against 5.62
// for x.mean(dim=(1, 2)) (chip_smoke.py): latency-bound, half a wave.
//
// Design. A thread loads V = 16 / sizeof(T) neighbouring channels as one
// 16-byte vector, and an output's window is split over `ry` threads (a
// block of bx x ry threads: x the output vector, y the window rows
// y, y + ry, ...), so all of a window's loads are in flight at once: at
// 7x7 each thread loads its row's 7 vectors before it adds them. The
// ry partial results meet in shared memory and the y == 0 thread
// combines them in row order (sum: f32 adds; max: the NaN-keeping max),
// scales and stores V outputs as one vector. The 7x7 global window and
// the 2x2/2 tiles of the digits LeNet are compiled for their window;
// every other window takes a run-time loop. Where C is not a multiple of
// V or a base is not 16-byte aligned the wrapper plans V = 1.
// ops/fused_pool.pool_fwd_plan gives V, ry and bx. This design takes
// 5.2 us on the training path's shape on the same card (chip_smoke.py),
// 1.34x its bound and under x.mean.
#include "common.cuh"

constexpr int kPoolShared = 4096;   // floats: bx * ry * V at most

template <bool MAX>
__device__ __forceinline__ float pool_step(float acc, float v) {
  if (MAX) return (v > acc || v != v) ? v : acc;   // a NaN wins and stays
  return __fadd_rn(acc, v);
}

// KH = KW = 0: the window's size at run time
template <typename T, int V, int KH, int KW, bool MAX>
__global__ void pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int64_t n_vec, int H, int W, int C, int kh_rt,
                                int kw_rt, int oy, int ox, int pre_relu,
                                float scale, int use_scale) {
  using IO = VecIO<T, V>;
  __shared__ __align__(16) float sh[kPoolShared];
  const int kh = KH ? KH : kh_rt, kw = KW ? KW : kw_rt;
  const int bx = blockDim.x, ry = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t o = (int64_t)blockIdx.x * bx + tx;
  const float init = MAX ? -INFINITY : 0.f;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = init;
  if (o < n_vec) {
    const int cvs = C / V;
    const int cv = (int)(o % cvs);
    int64_t r = o / cvs;
    const int j = (int)(r % ox);
    r /= ox;
    const int i = (int)(r % oy);
    const int64_t b = r / oy;
    const T* base =
        x + ((b * H + (int64_t)i * kh) * W + (int64_t)j * kw) * C + cv * V;
    for (int dy = ty; dy < kh; dy += ry) {
      const T* row = base + (int64_t)dy * W * C;
      if constexpr (KW > 0) {
        typename IO::Raw v[KW];
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
          v[dx] = IO::load(row + (int64_t)dx * C);
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float e = IO::at(v[dx], k);
            acc[k] = pool_step<MAX>(acc[k], pre_relu ? relu_f32(e) : e);
          }
      } else {
#pragma unroll 4
        for (int dx = 0; dx < kw; ++dx) {
          const typename IO::Raw v = IO::load(row + (int64_t)dx * C);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float e = IO::at(v, k);
            acc[k] = pool_step<MAX>(acc[k], pre_relu ? relu_f32(e) : e);
          }
        }
      }
    }
  }
  // the ry partials of each output, [row thread][output vector][channel]
  float* mine = sh + ((int64_t)ty * bx + tx) * V;
#pragma unroll
  for (int k = 0; k < V; ++k) mine[k] = acc[k];
  __syncthreads();
  if (ty != 0 || o >= n_vec) return;
  float t[V];
#pragma unroll
  for (int k = 0; k < V; ++k) t[k] = init;
  for (int p = 0; p < ry; ++p) {
    const float* part = sh + ((int64_t)p * bx + tx) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = pool_step<MAX>(t[k], part[k]);
  }
  typename IO::Raw out;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = use_scale ? round_to<T>(t[k]) * scale : t[k];
    out.v[k] = from_f32<T>(v);
  }
  *reinterpret_cast<typename IO::Raw*>(y + o * V) = out;
}

template <typename T, int V, int KH, int KW>
static void launch(const void* x, void* y, int64_t n_vec, int H, int W, int C,
                   int kh, int kw, int is_max, int pre_relu, float scale,
                   int ry, int bx, cudaStream_t s) {
  const dim3 block(bx, ry);
  const unsigned grid = (unsigned)((n_vec + bx - 1) / bx);
  const int use_scale = scale != 1.0f;
  if (is_max)
    pool_fwd_kernel<T, V, KH, KW, true><<<grid, block, 0, s>>>(
        (const T*)x, (T*)y, n_vec, H, W, C, kh, kw, H / kh, W / kw,
        pre_relu, scale, use_scale);
  else
    pool_fwd_kernel<T, V, KH, KW, false><<<grid, block, 0, s>>>(
        (const T*)x, (T*)y, n_vec, H, W, C, kh, kw, H / kh, W / kw,
        pre_relu, scale, use_scale);
}

template <typename T, int V>
static void launch_window(const void* x, void* y, int64_t n_vec, int H,
                          int W, int C, int kh, int kw, int is_max,
                          int pre_relu, float scale, int ry, int bx,
                          cudaStream_t s) {
  if (kh == 7 && kw == 7)
    launch<T, V, 7, 7>(x, y, n_vec, H, W, C, kh, kw, is_max, pre_relu, scale,
                       ry, bx, s);
  else if (kh == 2 && kw == 2)
    launch<T, V, 2, 2>(x, y, n_vec, H, W, C, kh, kw, is_max, pre_relu, scale,
                       ry, bx, s);
  else
    launch<T, V, 0, 0>(x, y, n_vec, H, W, C, kh, kw, is_max, pre_relu, scale,
                       ry, bx, s);
}

template <typename T>
static int pool_typed(const void* x, void* y, int64_t B, int H, int W, int C,
                      int kh, int kw, int is_max, int pre_relu, float scale,
                      int vec, int ry, int bx, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y) & 15) == 0 && C % VW == 0;
  if ((vec != 1 && (vec != VW || !aligned)) || ry < 1 || ry > kh || bx < 1 ||
      bx * ry > 1024 || bx * ry * vec > kPoolShared)
    return (int)cudaErrorInvalidValue;
  const int64_t n_vec = B * (int64_t)(H / kh) * (W / kw) * (C / vec);
  if (n_vec == 0) return 0;
  if (vec == VW)
    launch_window<T, VW>(x, y, n_vec, H, W, C, kh, kw, is_max, pre_relu,
                         scale, ry, bx, s);
  else
    launch_window<T, 1>(x, y, n_vec, H, W, C, kh, kw, is_max, pre_relu,
                        scale, ry, bx, s);
  return 0;
}

// x: (B, H, W, C) contiguous, y: (B, H/kh, W/kw, C) contiguous, both of
// dtype code `dtype`; vec, ry, bx: ops/fused_pool.pool_fwd_plan. Returns
// a cudaError_t (0 = launched).
extern "C" int pool_fwd(const void* x, void* y, int64_t B, int H, int W,
                        int C, int kh, int kw, int dtype, int is_max,
                        int pre_relu, float scale, int vec, int ry, int bx,
                        void* stream) {
  if (kh <= 0 || kw <= 0 || H % kh || W % kw) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  switch (dtype) {
    case kF32: rc = pool_typed<float>(x, y, B, H, W, C, kh, kw, is_max, pre_relu, scale, vec, ry, bx, s); break;
    case kBF16: rc = pool_typed<__nv_bfloat16>(x, y, B, H, W, C, kh, kw, is_max, pre_relu, scale, vec, ry, bx, s); break;
    case kF16: rc = pool_typed<__half>(x, y, B, H, W, C, kh, kw, is_max, pre_relu, scale, vec, ry, bx, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* pool_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
