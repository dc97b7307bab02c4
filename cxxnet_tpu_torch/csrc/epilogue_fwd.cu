// Bias + activation epilogue forward over (N, C) rows.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_epilogue.py:_epi_fwd_kernel
// (pallas_calls in _epi_bias_2d and _epi_act_2d). Same function:
// y = x + bias.astype(x.dtype), bias optional, then an optional relu, in
// the dtype of x. The add is done in f32 on the two values rounded to the
// dtype and rounded once; for bf16 and f16 that equals the add in the
// dtype itself (f32 carries more than twice their mantissa bits). The relu
// lets a NaN through, as torch.relu does.
//
// Bound on the H100 (3.35 TB/s): the bytes moved, x read once, y written
// once, bias read once. Every biased conv and fullc of a convnet runs it:
// AlexNet's cv1 at batch 256 ((774,400, 96) bf16, relu) is 297 MB, 0.0888
// ms; the SPP net's cv1 at batch 128 ((1,520,768, 96), bias only) 0.1743
// ms. On the serving path (fc1's bias on (B, 1000) bf16) the bytes are far
// below the launch.
//
// Design: bn_norm_vec.cuh's walk (norm_walk) under ops/fused_norm
// .bn_dx_plan, with EpiOp as its per-channel op. Thread t owns the V =
// 16 / sizeof(T) channels of group t % (C / V) for its whole loop, their
// bias rounded to the dtype once into registers; its stride is a multiple
// of C, so nothing divides in the loop. 16-byte loads of x and stores of
// y, kNormRows vectors in flight a thread, one wave of kNormCtasPerSm CTAs
// a SM. V = 1 where C or a base does not allow 16 bytes. Indices are
// 32-bit: rows past ops/fused_epilogue.EPI_FWD_SLICE elements are launched
// in slices of whole rows. On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py --ab) it takes 0.1089-0.1095 ms at AlexNet's cv1 (2.72
// TB/s, 1.23x its bound), 0.0716-0.0719 at cv2, 0.2095 at the SPP net's
// cv1 (torch.add of the bias alone 0.369) and 2.1-2.2 us at fc1; the
// design it replaced (one element a thread in a grid-stride loop, a
// 64-bit i % C for each element's bias) took 0.2039-0.2042, 0.1322-0.1328,
// 0.3968-0.3970 ms and 2.1-2.2 us in the same call.
#include "bn_norm_vec.cuh"

// The epilogue of channel j of a group: x + bias (rounded to T), relu
template <int V, bool BIAS, bool RELU>
struct EpiOp {
  float kb[V];
  __device__ __forceinline__ float operator()(float x, int j) const {
    const float v = BIAS ? __fadd_rn(x, kb[j]) : x;
    return RELU ? relu_f32(v) : v;
  }
};

// nv = rows * C / V vectors of one slice; thread t < stride = lanes *
// groups takes the vectors t, t + stride, ...
template <typename T, int V, bool BIAS, bool RELU>
__global__ void __launch_bounds__(kNormThreads, kNormCtasPerSm)
    epilogue_fwd_kernel(const T* __restrict__ x,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int nv, int groups, int stride) {
  const int t = blockIdx.x * kNormThreads + threadIdx.x;
  if (t >= stride) return;
  EpiOp<V, BIAS, RELU> op;
  if (BIAS) {
    const int c0 = t % groups * V;
#pragma unroll
    for (int j = 0; j < V; ++j) op.kb[j] = round_to<T>(bias[c0 + j]);
  }
  norm_walk<T, V>(x, y, t, stride, nv, op);
}

template <typename T, int V, bool BIAS, bool RELU>
static void launch_slices(const T* x, const float* bias, T* y, int64_t rows,
                          int C, int64_t lanes, int blocks,
                          int64_t slice_rows, cudaStream_t s) {
  const int groups = C / V;
  for (int64_t r0 = 0; r0 < rows; r0 += slice_rows) {
    const int64_t n = rows - r0 < slice_rows ? rows - r0 : slice_rows;
    epilogue_fwd_kernel<T, V, BIAS, RELU><<<blocks, kNormThreads, 0, s>>>(
        x + r0 * C, bias, y + r0 * C, (int)(n * groups), groups,
        (int)(lanes * groups));
  }
}

template <typename T, int V>
static void launch_act(const void* x, const float* bias, void* y,
                       int64_t rows, int C, int64_t lanes, int blocks,
                       int64_t slice_rows, int relu, cudaStream_t s) {
#define EPI_FWD(BIAS_, RELU_)                                             \
  launch_slices<T, V, BIAS_, RELU_>((const T*)x, bias, (T*)y, rows, C,    \
                                    lanes, blocks, slice_rows, s)
  if (bias == nullptr) EPI_FWD(false, true);
  else if (relu) EPI_FWD(true, true);
  else EPI_FWD(true, false);
#undef EPI_FWD
}

// The elements a slice may hold and the threads of a grid: a slice's
// vector indices, and each thread's last index kNormRows strides past its
// end, stay below 2^31
constexpr int64_t kMaxSliceElems = (int64_t)1 << 30;
constexpr int64_t kMaxThreads = (int64_t)1 << 28;

template <typename T>
static int run(const void* x, const float* bias, void* y, int64_t rows,
               int C, int vec, int64_t lanes, int blocks, int64_t slice_rows,
               int relu, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (!norm_plan_ok<T>(x, y, rows, C, vec, lanes, blocks) ||
      slice_rows < 1 || slice_rows * C > kMaxSliceElems ||
      (int64_t)blocks * kNormThreads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (vec == VW)
    launch_act<T, VW>(x, bias, y, rows, C, lanes, blocks, slice_rows, relu,
                      s);
  else
    launch_act<T, 1>(x, bias, y, rows, C, lanes, blocks, slice_rows, relu,
                     s);
  return 0;
}

// x, y: (rows, C) contiguous of dtype code `dtype`; bias: (C,) float32 or
// NULL (then relu must be set). vec, lanes, blocks, slice_rows:
// ops/fused_epilogue.epilogue_fwd_plan. Returns a cudaError_t (0 =
// launched); cudaErrorInvalidValue for a plan the inputs do not allow.
extern "C" int epilogue_fwd(const void* x, const void* bias, void* y,
                            int64_t rows, int C, int vec, int64_t lanes,
                            int blocks, int64_t slice_rows, int dtype,
                            int relu, void* stream) {
  if (C <= 0 || rows < 0 || (bias == nullptr && !relu))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  DISPATCH(dtype, rc = (run<T>(x, (const float*)bias, y, rows, C, vec, lanes,
                               blocks, slice_rows, relu, s)));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* epilogue_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
