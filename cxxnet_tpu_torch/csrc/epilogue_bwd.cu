// Bias + activation epilogue backward over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_epilogue.py:_epi_bwd_kernel
// (pallas_calls in _epi_act_bwd and _epi_bias_bwd). Same function:
// dx = dy, masked to 0 where the forward's output y is not > 0 when the
// relu was folded in; with a bias, dbias = the column sum of that dx in
// f32. dx keeps the dtype of dy.
//
// Bound on the H100 (3.35 TB/s): dy (and y, with relu) read once, dx and
// dbias written once. On the training path (fc1's bias on (128, 1000)
// bf16, no relu) that is 0.26 MB + 0.26 MB + 4 KB, 0.16 us: far below the
// two launches this design makes, so the kernel is launch-bound there:
// 4.6 us on an H100 80GB HBM3 at 700 W (chip_smoke.py).
//
// Design: with a bias, the two-stage column sums of colsum.cuh, whose
// first stage also writes dx (every element is visited exactly once
// there), then a finalize kernel that adds the partials of each channel in
// row-block order: no atomics, repeated runs agree bit for bit. Without a
// bias, one masked copy in a grid-stride loop.
#include "colsum.cuh"

template <typename T>
struct MaskCopySum {  // dx = masked dy, a += dx
  const T* y;
  const T* dy;
  T* dx;
  int relu;
  __device__ void operator()(int64_t i, int, float& a, float&) const {
    T v = dy[i];
    if (relu && !(to_f32(y[i]) > 0.f)) v = from_f32<T>(0.f);
    dx[i] = v;
    a += to_f32(v);
  }
};

template <typename T>
__global__ void mask_copy(const T* __restrict__ y, const T* __restrict__ dy,
                          T* __restrict__ dx, int64_t n, int relu) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    T v = dy[i];
    if (relu && !(to_f32(y[i]) > 0.f)) v = from_f32<T>(0.f);
    dx[i] = v;
  }
}

__global__ void finalize_dbias(const float* __restrict__ p, int G, int C,
                               float* dbias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) dbias[c] = sum_partials(p, G, C, c);
}

template <typename T>
static void run(const void* y, const void* dy, void* dx, float* dbias,
                float* part, int64_t N, int C, int G, int relu,
                cudaStream_t s) {
  if (dbias == nullptr) {
    const int64_t n = N * C;
    mask_copy<T><<<grid_for(n, 256), 256, 0, s>>>(
        (const T*)y, (const T*)dy, (T*)dx, n, relu);
    return;
  }
  launch_colsum(MaskCopySum<T>{(const T*)y, (const T*)dy, (T*)dx, relu}, N,
                C, G, part, nullptr, s);
  finalize_dbias<<<(C + 255) / 256, 256, 0, s>>>(part, G, C, dbias);
}

// y (the forward's output; read only with relu), dy, dx: (N, C) contiguous
// of dtype code `dtype`; dbias: (C,) f32 output or NULL for an act-only
// epilogue; part: G * C f32 scratch (unused without dbias). Returns a
// cudaError_t (0 = launched).
extern "C" int epilogue_bwd(const void* y, const void* dy, void* dx,
                            float* dbias, float* part, int64_t N, int C,
                            int G, int dtype, int relu, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: run<float>(y, dy, dx, dbias, part, N, C, G, relu, s); break;
    case kBF16: run<__nv_bfloat16>(y, dy, dx, dbias, part, N, C, G, relu, s); break;
    case kF16: run<__half>(y, dy, dx, dbias, part, N, C, G, relu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* epilogue_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
