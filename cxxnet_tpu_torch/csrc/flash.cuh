// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the operands' layout, the argument check and the dispatch over head
// width, and the thread layout of the f32 kernels on the CUDA cores
// (flash_tc.cuh has the bf16/f16 kernels' tensor-core tiles).
//
// Layout: q, k, v, o, dO, dq, dk, dv are (B, S, H, D) contiguous, read and
// written through their strides (row stride H * D), so no transpose to
// (B * H, S, D) is made around the kernels (the TPU wrapper makes one,
// cxxnet_tpu/ops/attention.py:328-330). lse and delta are (B, H, Sq) f32.
//
// f32 kernels: a CTA owns 64 rows (query rows, or key rows in the dK/dV
// kernel). A row is held by DMAX / 16 neighbouring threads of one warp,
// each with 16 of its DMAX features in registers; DMAX is D rounded up to
// 16, 32, 64 or 128, the features past D are zeros. A dot product of two
// rows is 16 FMAs per thread and a butterfly of shuffles over the row's
// threads, after which every thread of the row holds it. The other
// operand's tile (keys and values, or queries, dO, lse and delta) is
// staged in shared memory as f32. All math is f32, as the TPU kernels'
// is after their astype(f32).
#pragma once

#include "common.cuh"

namespace flash {

constexpr float kNeg = -1e30f;   // the masked logit (attention.py _NEG)
constexpr int kRows = 64;        // rows a CTA owns
constexpr int kSlice = 16;       // features a thread holds

// rows of the staged tile: 32 KB of shared memory for two f32 tiles
template <int DMAX> struct Tile {
  static constexpr int kRowsStaged = (4096 / DMAX) < 64 ? (4096 / DMAX) : 64;
};

// sum of x over the TPR neighbouring threads of a row (all end with it)
template <int TPR> __device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the 16-feature part of a dot product: a (registers) . b (a staged row)
__device__ __forceinline__ float part_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kSlice; ++t) acc = fmaf(a[t], b[t], acc);
  return acc;
}

// key kj counts for query qi: inside both lengths and, when causal, not in
// the future (the TPU kernels' _block_causal_mask, qpos >= kpos)
__device__ __forceinline__ bool keep(int qi, int kj, int Sq, int Sk,
                                     int causal) {
  return qi < Sq && kj < Sk && (!causal || kj <= qi);
}

// a row's 16 features from global memory as f32 (zeros past D or S)
template <typename T>
__device__ __forceinline__ void load_part(float* dst, const T* row, int part,
                                          int D, bool valid) {
#pragma unroll
  for (int t = 0; t < kSlice; ++t) {
    const int d = part * kSlice + t;
    dst[t] = (valid && d < D) ? to_f32(row[d]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_part(T* row, const float* src, int part,
                                           int D) {
#pragma unroll
  for (int t = 0; t < kSlice; ++t) {
    const int d = part * kSlice + t;
    if (d < D) row[d] = from_f32<T>(src[t]);
  }
}

// stage rows [r0, r0 + R) of a (B, S, H, D) tensor's (b, h) slice as f32
template <typename T, int DMAX, int R>
__device__ __forceinline__ void stage(float (*dst)[DMAX], const T* base,
                                      int64_t rs, int r0, int S, int D) {
  for (int idx = threadIdx.x; idx < R * DMAX; idx += blockDim.x) {
    const int r = idx / DMAX, d = idx % DMAX;
    dst[r][d] = (r0 + r < S && d < D) ? to_f32(base[(int64_t)(r0 + r) * rs + d])
                                      : 0.f;
  }
}

}  // namespace flash

// the launch statement (the variadic arguments) once for D's width
// bucket, with DMAX defined for it
#define FLASH_DMAX(D, ...)                                          \
  if ((D) <= 16) { constexpr int DMAX = 16; __VA_ARGS__; }          \
  else if ((D) <= 32) { constexpr int DMAX = 32; __VA_ARGS__; }     \
  else if ((D) <= 64) { constexpr int DMAX = 64; __VA_ARGS__; }     \
  else { constexpr int DMAX = 128; __VA_ARGS__; }

// the arguments every entry point checks: D even in [2, 128], positive
// sizes, grid dimensions in range
static inline bool flash_args_ok(int B, int Sq, int Sk, int H, int D) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && D >= 2 && D <= 128 &&
         D % 2 == 0 && (Sq + flash::kRows - 1) / flash::kRows <= 65535 &&
         (Sk + flash::kRows - 1) / flash::kRows <= 65535;
}
