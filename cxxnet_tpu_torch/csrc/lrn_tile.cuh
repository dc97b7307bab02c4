// The shared-memory tile of the LRN kernels (lrn_fwd.cu, lrn_bwd.cu) and
// the checks of their plan (ops/fused_lrn.lrn_plan).
//
// A block is tpr x rows threads (threadIdx.x along the channels, .y the
// row): it owns `rows` rows and, of each, the `chunk` channels from c0 =
// blockIdx.y * chunk (chunk = C where a row's vectors fit one block, so
// that nothing comes from another block). Thread tx takes V contiguous
// channels, c0 + tx * V, as one vector load. A row's tile holds, in f32,
// the chunk and h = nsize - 1 channels on each side: slot i is channel
// c0 - h + i, and channels outside [0, C) hold 0. Slot i lies at
// tile_pos(i) = i + i / V floats: one pad after every V slots, so that
// the lanes of a warp, which read slots V apart, read V + 1 floats apart,
// a bank each.
#pragma once

#include "common.cuh"

constexpr int kLrnMaxThreads = 512;       // ops/fused_lrn.LRN_MAX_TPR
constexpr int kLrnSmem = 227 * 1024;      // ops/fused_lrn.LRN_SMEM

template <int V>
__host__ __device__ __forceinline__ int tile_pos(int i) {
  return V > 1 ? i + (int)((unsigned)i / V) : i;
}

// the tile of thread tx's first slot: slot tx * V + q lies at t[tile_pos(q)]
template <int V, typename F>
__device__ __forceinline__ F* thread_tile(F* row_tile, int tx) {
  return row_tile + tx * (V > 1 ? V + 1 : 1);
}

// V elements from p as one vector, in f32; zeros where !ok
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, bool ok, float (&v)[V]) {
  if (ok) {
    const typename VecIO<T, V>::Raw r = VecIO<T, V>::load(p);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = VecIO<T, V>::at(r, k);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.f;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  VecOf<T, V> out;
#pragma unroll
  for (int k = 0; k < V; ++k) out.v[k] = from_f32<T>(v[k]);
  *reinterpret_cast<VecOf<T, V>*>(p) = out;
}

// v[k] into the thread's own slots, tx * V + h + k
template <int V>
__device__ __forceinline__ void stage_own(float* row_tile, int tx, int h,
                                          const float (&v)[V]) {
  float* t = thread_tile<V>(row_tile, tx);
#pragma unroll
  for (int k = 0; k < V; ++k) t[tile_pos<V>(h + k)] = v[k];
}

// The 2h halo slots of the row: x^2 of channels c0 - h .. c0 - 1 and
// c0 + chunk .. c0 + chunk + h - 1, zero outside [0, C) (all of them
// where the block holds whole rows). xrow is the row's first element.
template <typename T, int V>
__device__ __forceinline__ void stage_halo(float* row_tile, const T* xrow,
                                           bool row_ok, int C, int c0,
                                           int chunk, int h, int tx) {
  for (int s = tx; s < 2 * h; s += blockDim.x) {
    const int slot = s < h ? s : chunk + s;
    const int c = c0 - h + slot;
    float v = 0.f;
    if (row_ok && c >= 0 && c < C) {
      v = to_f32(xrow[c]);
      v = __fmul_rn(v, v);
    }
    row_tile[tile_pos<V>(slot)] = v;
  }
}

// sums[k] = the sum over m < nsize of slot tx * V + off + k + m, added in
// ascending m from 0. N > 0: nsize = N at compile time, the V + N - 1
// slots read once into registers; N = 0: each term read from the tile.
template <int V, int N>
__device__ __forceinline__ void window_sums(const float* row_tile, int tx,
                                            int off, int nsize,
                                            float (&sums)[V]) {
  const float* t = thread_tile<V>(row_tile, tx);
  if constexpr (N > 0) {
    float w[V + N - 1];
#pragma unroll
    for (int j = 0; j < V + N - 1; ++j) w[j] = t[tile_pos<V>(off + j)];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) s = __fadd_rn(s, w[k + m]);
      sums[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s = 0.f;
      for (int m = 0; m < nsize; ++m)
        s = __fadd_rn(s, t[tile_pos<V>(off + k + m)]);
      sums[k] = s;
    }
  }
}

// norm = knorm + ab * win; returns p = exp(nbeta * log(norm)), the plain
// version's rounding at each step
__device__ __forceinline__ float lrn_scale(float win, float ab, float knorm,
                                           float nbeta, float* norm) {
  *norm = __fadd_rn(knorm, __fmul_rn(ab, win));
  return expf(__fmul_rn(nbeta, logf(*norm)));
}

// Whether a plan (vec, rows, chunk, stride) is one the kernels take for
// n_rows x C elements of `itemsize` bytes at the given bases: the checks
// of ops/fused_lrn.lrn_plan, and the bases aligned to the vector.
static inline bool lrn_plan_ok(int64_t n_rows, int C, int nsize, int itemsize,
                               int vec, int rows, int chunk, int stride,
                               const void* const* bases, int n_bases) {
  if (C <= 0 || nsize <= 0 || n_rows < 0 || rows < 1 || chunk < 1) return false;
  if (vec != 1 && vec != 2 && vec != 4 && vec != 8) return false;
  if (vec * itemsize > 16 || C % vec || chunk % vec || chunk > C) return false;
  const int tpr = chunk / vec;
  if ((int64_t)tpr * rows > kLrnMaxThreads) return false;
  if (chunk < C && tpr < nsize - 1) return false;   // one halo t a thread
  const int64_t width = (int64_t)chunk + 2 * (int64_t)(nsize - 1);
  const int64_t need = vec > 1 ? width + (width - 1) / vec : width;
  if (stride < need || (int64_t)rows * stride * 4 > kLrnSmem) return false;
  if ((C + (int64_t)chunk - 1) / chunk > 65535) return false;
  for (int i = 0; i < n_bases; ++i)
    if ((uintptr_t)bases[i] % (uintptr_t)(vec * itemsize)) return false;
  return true;
}

// The launch of a tile kernel: the grid and block of the plan, and the
// dynamic shared memory (raising the kernel's cap above 48 KB).
template <typename K>
static cudaError_t lrn_configure(K kernel, int64_t n_rows, int C, int vec,
                                 int rows, int chunk, int stride, dim3* grid,
                                 dim3* block, size_t* smem) {
  *smem = (size_t)rows * stride * sizeof(float);
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return e;
  }
  *grid = dim3((unsigned)((n_rows + rows - 1) / rows),
               (unsigned)((C + chunk - 1) / chunk));
  *block = dim3((unsigned)(chunk / vec), (unsigned)rows);
  return cudaSuccess;
}
