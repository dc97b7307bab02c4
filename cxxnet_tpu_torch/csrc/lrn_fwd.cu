// Cross-channel local response normalization, forward, over (N, C) rows
// (an NHWC node with C contiguous).
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_lrn.py:_lrn_fwd_kernel
// (pallas_call in _lrn_2d). Same function, f32 inside and one rounding to
// the dtype at the end:
//   win[c]  = sum of x[c']^2 over c' in [c - half, c + nsize - 1 - half],
//             zeros past the edges, half = nsize / 2
//   norm[c] = knorm + (alpha / nsize) * win[c]
//   y[c]    = x[c] * exp(-beta * log(norm[c]))
// The TPU sums the window as a matmul against a (C, C) band matrix to
// reach its matrix unit; here each output adds its nsize squares in
// ascending channel order, the order of the plain version, with no fused
// multiply-adds and expf/logf without fast math: y is bit-equal to
// ops/fused_lrn.lrn_plain.
//
// Bound on the H100 (3.35 TB/s): bytes, x read once and y written once.
// At AlexNet's lrn1 (256, 27, 27, 96) bf16 that is 71.7 MB, 21.4 us; at
// lrn2 (256, 13, 13, 256) 44.3 MB, 13.2 us.
//
// The first design (a block of R rows by a chunk of channels, scalar
// 2-byte loads, a run-time division per element, x read twice) took
// 0.1319 ms at lrn1 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py),
// 6.2x its bound.
//
// Design (lrn_tile.cuh): a block owns whole rows, so no halo comes from
// another block, and a thread one vector of V channels (16 bytes where C
// and the bases allow), read once and kept in registers. The thread
// writes its V squares into the rows' f32 tile, the block syncs once,
// and the thread reads the V + nsize - 1 slots of its windows into
// registers (nsize 5 compiled in; any other nsize reads each term from
// the tile), forms V outputs and stores them as one vector. Where a row's
// vectors outgrow a block, blocks take chunks of a row with their halo.
// ops/fused_lrn.lrn_plan gives V, the rows, the chunk and the tile.
// This design takes 0.0404 ms at lrn1 and 0.0255 at lrn2 on the same
// card (chip_smoke.py --ab), 1.9x its bound and no faster from the L2:
// instruction issue sets the pace (60.5 SASS instructions an element,
// most in the accurate logf and expf, at 82% of the issue rate).
#include "lrn_tile.cuh"

template <typename T, int V, int N>
__global__ void __launch_bounds__(kLrnMaxThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n_rows,
               int C, int chunk, int stride, int nsize_rt, float ab,
               float knorm, float nbeta) {
  extern __shared__ float tile_mem[];
  const int nsize = N > 0 ? N : nsize_rt;
  const int h = nsize - 1, half = nsize / 2;
  const int tx = threadIdx.x;
  float* tile = tile_mem + threadIdx.y * stride;
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int c0 = blockIdx.y * chunk;
  const int c = c0 + tx * V;
  const bool row_ok = row < n_rows, ok = row_ok && c < C;
  const T* xrow = x + row * C;
  float xv[V], sq[V];
  load_vec<T, V>(xrow + c, ok, xv);
#pragma unroll
  for (int k = 0; k < V; ++k) sq[k] = __fmul_rn(xv[k], xv[k]);
  stage_own<V>(tile, tx, h, sq);
  stage_halo<T, V>(tile, xrow, row_ok, C, c0, chunk, h, tx);
  __syncthreads();
  if (!ok) return;
  float win[V], out[V];
  window_sums<V, N>(tile, tx, h - half, nsize, win);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float norm;
    out[k] = __fmul_rn(xv[k], lrn_scale(win[k], ab, knorm, nbeta, &norm));
  }
  store_vec<T, V>(y + row * C + c, out);
}

template <typename T, int V, int N>
static int launch(const void* x, void* y, int64_t n, int C, int nsize,
                  float ab, float knorm, float nbeta, int vec, int rows,
                  int chunk, int stride, cudaStream_t s) {
  dim3 grid, block;
  size_t smem;
  cudaError_t e = lrn_configure(lrn_fwd_kernel<T, V, N>, n, C, vec, rows,
                                chunk, stride, &grid, &block, &smem);
  if (e != cudaSuccess) return (int)e;
  lrn_fwd_kernel<T, V, N><<<grid, block, smem, s>>>(
      (const T*)x, (T*)y, n, C, chunk, stride, nsize, ab, knorm, nbeta);
  return (int)cudaGetLastError();
}

template <typename T, int N>
static int launch_vec(const void* x, void* y, int64_t n, int C, int nsize,
                      float ab, float knorm, float nbeta, int vec, int rows,
                      int chunk, int stride, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1, N>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    case 2: return launch<T, 2, N>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    case 4: return launch<T, 4, N>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, N>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_dtype(const void* x, void* y, int64_t n, int C, int nsize,
                        float ab, float knorm, float nbeta, int vec, int rows,
                        int chunk, int stride, cudaStream_t s) {
  const void* bases[2] = {x, y};
  if (!lrn_plan_ok(n, C, nsize, (int)sizeof(T), vec, rows, chunk, stride,
                   bases, 2))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (nsize == 5)
    return launch_vec<T, 5>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
  return launch_vec<T, 0>(x, y, n, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
}

// x, y: (n_rows, C) contiguous of dtype code `dtype`. ab = alpha / nsize
// and nbeta = -beta, both rounded to float by the caller; vec, rows,
// chunk and stride: the plan of ops/fused_lrn.lrn_plan. Returns a
// cudaError_t (0 = launched; cudaErrorInvalidValue for a plan the
// inputs do not allow).
extern "C" int lrn_fwd(const void* x, void* y, int64_t n_rows, int C,
                       int nsize, int dtype, float ab, float knorm,
                       float nbeta, int vec, int rows, int chunk, int stride,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch_dtype<float>(x, y, n_rows, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    case kBF16: return launch_dtype<__nv_bfloat16>(x, y, n_rows, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    case kF16: return launch_dtype<__half>(x, y, n_rows, C, nsize, ab, knorm, nbeta, vec, rows, chunk, stride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lrn_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
