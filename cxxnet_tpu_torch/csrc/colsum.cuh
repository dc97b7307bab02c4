// Per-channel column sums over (N, C) rows, in two stages: a grid of
// row-block CTAs writes f32 partial sums per (row block, channel), and a
// finalize kernel adds the partials of each channel in row-block order.
// Shared by the batch-norm forward and backward and the epilogue backward.
//
// No atomics: every partial is summed in a fixed order, so two runs on
// the same input agree bit for bit.
//
// CTA (g, t) of a grid (G, ceil(C / 32)) with blocks of (32, 8) threads
// owns rows [g * rows_per, min(N, (g + 1) * rows_per)) of channels
// t * 32 .. t * 32 + 31. threadIdx.x is the channel, so the 32 threads of
// a warp read 32 neighbouring channels of one row (one coalesced read);
// threadIdx.y is one of 8 row lanes, each taking every 8th row. The eight
// lanes' sums meet in shared memory and lane 0 writes the CTA's partials.
#pragma once

#include "common.cuh"

constexpr int kChanTile = 32;
constexpr int kRowLanes = 8;

// Op: __device__ void operator()(int64_t i, int c, float& a, float& b)
// adds element i (channel c) of its inputs into the two accumulators.
template <typename Op>
__global__ void colsum_partials(Op op, int64_t N, int C, int64_t rows_per,
                                float* __restrict__ p1,
                                float* __restrict__ p2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kChanTile + tx;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per;
  const int64_t r1 = r0 + rows_per < N ? r0 + rows_per : N;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int64_t r = r0 + ty; r < r1; r += kRowLanes) op(r * C + c, c, a, b);
  }
  __shared__ float sa[kRowLanes][kChanTile];
  __shared__ float sb[kRowLanes][kChanTile];
  sa[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
    for (int k = 0; k < kRowLanes; ++k) {
      ta += sa[k][tx];
      tb += sb[k][tx];
    }
    p1[(int64_t)blockIdx.x * C + c] = ta;
    if (p2 != nullptr) p2[(int64_t)blockIdx.x * C + c] = tb;
  }
}

template <typename Op>
static void launch_colsum(Op op, int64_t N, int C, int G, float* p1,
                          float* p2, cudaStream_t s) {
  const int64_t rows_per = (N + G - 1) / G;
  dim3 grid(G, (C + kChanTile - 1) / kChanTile);
  dim3 block(kChanTile, kRowLanes);
  colsum_partials<Op><<<grid, block, 0, s>>>(op, N, C, rows_per, p1, p2);
}

// the sum over row blocks of channel c's partials, in row-block order
__device__ __forceinline__ float sum_partials(const float* __restrict__ p,
                                              int G, int C, int c) {
  float t = 0.f;
  for (int g = 0; g < G; ++g) t += p[(int64_t)g * C + c];
  return t;
}
