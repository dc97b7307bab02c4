// Cross-channel local response normalization, backward, over (N, C) rows
// (an NHWC node with C contiguous).
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_lrn.py:_lrn_bwd_kernel
// (pallas_call in _lrn_bwd). Same function, f32 inside and one rounding
// to the dtype at the end, with norm recomputed from x as the TPU kernel
// does (no saved intermediate):
//   norm[c] = knorm + (alpha / nsize) * (sum of x^2 over the window of c)
//   p[c]    = exp(-beta * log(norm[c]))              (norm^-beta)
//   t[j]    = dy[j] * x[j] * (p[j] / norm[j])
//   back[c] = sum of t[j] over the j whose window holds c, that is j in
//             [c - (nsize - 1 - half), c + half]  (the transposed window)
//   dx[c]   = dy[c] * p[c] - (2 * (alpha / nsize) * beta) * x[c] * back[c]
// For even nsize the forward window [c - half, c + nsize - 1 - half] and
// the transposed one differ; both sums run in ascending channel order,
// the plain version's order, with no fused multiply-adds: dx is
// bit-equal to ops/fused_lrn.lrn_bwd_plain.
//
// Bound on the H100 (3.35 TB/s): bytes, x and dy read once and dx written
// once. At AlexNet's lrn1 (256, 27, 27, 96) bf16 that is 107.5 MB,
// 32.1 us; at lrn2 (256, 13, 13, 256) 66.4 MB, 19.8 us.
//
// The first design (a block of R rows by a chunk, three f32 tiles, p and
// t recomputed over the chunk's halo, scalar loads with a run-time
// division per element, x read three times and dy twice) took 0.2270 ms
// at lrn1 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), 7.1x its
// bound.
//
// Design (lrn_tile.cuh): a block owns whole rows and a thread one vector
// of V channels of x and of dy, each read once into registers. One f32
// tile: the thread writes its x^2, the block syncs, the thread forms
// norm, p and t of its own channels once (and dx's products dy * p and
// coef * x, kept in registers), the block syncs, the thread writes t
// over its x^2, the block syncs, and the thread sums t over its
// transposed windows and stores V of dx as one vector. Where a row's
// vectors outgrow a block, blocks take chunks of a row; then the x^2
// halo is loaded, and the nsize - 1 threads at the front of each row
// form t of one halo channel each. This design takes 0.0632 ms at lrn1
// and 0.0397 at lrn2 on the same card (chip_smoke.py --ab), 2.0x its
// bound and no faster from the L2: the arithmetic's issue sets the pace.
#include "lrn_tile.cuh"

template <typename T, int V, int N>
__global__ void __launch_bounds__(kLrnMaxThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               T* __restrict__ dx, int64_t n_rows, int C, int chunk,
               int stride, int nsize_rt, float ab, float knorm, float nbeta,
               float coef) {
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
  const T* dyrow = dy + row * C;
  float xv[V], dyv[V], v[V];
  load_vec<T, V>(xrow + c, ok, xv);
  load_vec<T, V>(dyrow + c, ok, dyv);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __fmul_rn(xv[k], xv[k]);
  stage_own<V>(tile, tx, h, v);
  stage_halo<T, V>(tile, xrow, row_ok, C, c0, chunk, h, tx);
  __syncthreads();
  // t of the thread's channels (v holds the window sums, then t); dx's
  // two products, dy * p and coef * x, are formed now and kept in place
  // of dy and x (two arrays live across the barriers, not three)
  window_sums<V, N>(tile, tx, h - half, nsize, v);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float norm;
    const float p = lrn_scale(v[k], ab, knorm, nbeta, &norm);
    v[k] = ok ? __fmul_rn(__fmul_rn(dyv[k], xv[k]), __fdiv_rn(p, norm))
              : 0.f;
    dyv[k] = __fmul_rn(dyv[k], p);
    xv[k] = __fmul_rn(coef, xv[k]);
  }
  // chunks only: t of the halo channel of slot ht, thread tx < h
  float th = 0.f;
  int ht = -1;
  if (gridDim.y > 1 && tx < h) {
    ht = tx < h - half ? half + tx : chunk + half + tx;
    const int ch = c0 - h + ht;
    if (row_ok && ch >= 0 && ch < C) {
      float win = 0.f, norm;
      for (int m = 0; m < nsize; ++m)
        win = __fadd_rn(win, tile[tile_pos<V>(ht - half + m)]);
      const float ph = lrn_scale(win, ab, knorm, nbeta, &norm);
      th = __fmul_rn(__fmul_rn(to_f32(dyrow[ch]), to_f32(xrow[ch])),
                     __fdiv_rn(ph, norm));
    }
  }
  __syncthreads();
  stage_own<V>(tile, tx, h, v);
  if (ht >= 0) tile[tile_pos<V>(ht)] = th;
  __syncthreads();
  if (!ok) return;
  window_sums<V, N>(tile, tx, half, nsize, v);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __fsub_rn(dyv[k], __fmul_rn(xv[k], v[k]));
  store_vec<T, V>(dx + row * C + c, v);
}

template <typename T, int V, int N>
static int launch(const void* x, const void* dy, void* dx, int64_t n, int C,
                  int nsize, float ab, float knorm, float nbeta, float coef,
                  int vec, int rows, int chunk, int stride, cudaStream_t s) {
  dim3 grid, block;
  size_t smem;
  cudaError_t e = lrn_configure(lrn_bwd_kernel<T, V, N>, n, C, vec, rows,
                                chunk, stride, &grid, &block, &smem);
  if (e != cudaSuccess) return (int)e;
  lrn_bwd_kernel<T, V, N><<<grid, block, smem, s>>>(
      (const T*)x, (const T*)dy, (T*)dx, n, C, chunk, stride, nsize, ab,
      knorm, nbeta, coef);
  return (int)cudaGetLastError();
}

template <typename T, int N>
static int launch_vec(const void* x, const void* dy, void* dx, int64_t n,
                      int C, int nsize, float ab, float knorm, float nbeta,
                      float coef, int vec, int rows, int chunk, int stride,
                      cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1, N>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    case 2: return launch<T, 2, N>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    case 4: return launch<T, 4, N>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, N>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_dtype(const void* x, const void* dy, void* dx, int64_t n,
                        int C, int nsize, float ab, float knorm, float nbeta,
                        float coef, int vec, int rows, int chunk, int stride,
                        cudaStream_t s) {
  const void* bases[3] = {x, dy, dx};
  if (!lrn_plan_ok(n, C, nsize, (int)sizeof(T), vec, rows, chunk, stride,
                   bases, 3))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (nsize == 5)
    return launch_vec<T, 5>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
  return launch_vec<T, 0>(x, dy, dx, n, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
}

// x, dy, dx: (n_rows, C) contiguous of dtype code `dtype`. ab = alpha /
// nsize, nbeta = -beta and coef = 2 * (alpha / nsize) * beta, each rounded
// to float by the caller; vec, rows, chunk and stride: the plan of
// ops/fused_lrn.lrn_plan. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for a plan the inputs do not allow).
extern "C" int lrn_bwd(const void* x, const void* dy, void* dx,
                       int64_t n_rows, int C, int nsize, int dtype, float ab,
                       float knorm, float nbeta, float coef, int vec,
                       int rows, int chunk, int stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch_dtype<float>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    case kBF16:
      return launch_dtype<__nv_bfloat16>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    case kF16:
      return launch_dtype<__half>(x, dy, dx, n_rows, C, nsize, ab, knorm, nbeta, coef, vec, rows, chunk, stride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lrn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
