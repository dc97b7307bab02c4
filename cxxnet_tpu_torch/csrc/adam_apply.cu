// Adam apply over many f32 tensors in one launch, in place.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_optim.py:_adam_kernel
// (pallas_call in _run, from fused_adam_apply). Same function, per element
// of every leaf of one tag group: a NaN gradient becomes 0, the gradient is
// clipped to [-clip, clip] (clip != 0), wd * w is added (wd != 0), then
//   m1' = m1 + d1 * (g - m1)
//   m2' = m2 + d2 * (g * g - m2)
//   w'  = w - (lr_t * m1') / (sqrt(m2') + 1e-8)
// in f32 with the rounded operations of the plain version (no contraction
// into an FMA, IEEE division and square root), so kernel and plain agree to
// the bit. lr_t carries the bias correction, computed once per step on the
// host in float32 (optim.adam_lr_t), and is an argument of every launch.
//
// Bound on the H100 (3.35 TB/s): w, g, m1 and m2 read once and w, m1 and m2
// written once, 28 bytes per parameter: 6.0 MB (1.8 us) for the long-context
// LM's 215 k parameters, where one launch costs more than the bytes; 0.32 GB
// (0.094 ms) at Inception-BN's 11.3 M.
//
// Design: sgd_apply.cu's, with one more pointer list. The caller uploads a
// table of int64s: the w, g, m1 and m2 pointers and the size of each leaf,
// then for each CTA the leaf it works on and the first element of its
// chunk. A CTA updates up to `chunk` elements of one leaf in a grid-stride
// loop, neighbouring threads on neighbouring elements.
#include "common.cuh"

__global__ void adam_apply_kernel(const int64_t* __restrict__ table,
                                  int n_leaves, int n_blocks, int chunk,
                                  float lr_t, float d1, float d2, float wd,
                                  float clip) {
  const int64_t leaf = table[5 * (int64_t)n_leaves + blockIdx.x];
  const int64_t start = table[5 * (int64_t)n_leaves + n_blocks + blockIdx.x];
  float* w = (float*)table[leaf];
  const float* g = (const float*)table[n_leaves + leaf];
  float* m1 = (float*)table[2 * n_leaves + leaf];
  float* m2 = (float*)table[3 * n_leaves + leaf];
  const int64_t size = table[4 * n_leaves + leaf];
  const int64_t end = start + chunk < size ? start + chunk : size;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float wv = w[i];
    float gv = g[i];
    if (gv != gv) gv = 0.f;
    if (clip != 0.f) gv = fminf(fmaxf(gv, -clip), clip);
    if (wd != 0.f) gv = __fadd_rn(gv, __fmul_rn(wd, wv));
    const float a = m1[i];
    const float b = m2[i];
    const float na = __fadd_rn(a, __fmul_rn(d1, __fsub_rn(gv, a)));
    const float nb = __fadd_rn(b, __fmul_rn(d2, __fsub_rn(__fmul_rn(gv, gv), b)));
    const float den = __fadd_rn(__fsqrt_rn(nb), 1e-8f);
    w[i] = __fsub_rn(wv, __fdiv_rn(__fmul_rn(lr_t, na), den));
    m1[i] = na;
    m2[i] = nb;
  }
}

// table: device int64 array of 5 * n_leaves + 2 * n_blocks entries, laid
// out [w ptrs | g ptrs | m1 ptrs | m2 ptrs | sizes | CTA leaf | CTA chunk
// start]. Returns a cudaError_t (0 = launched).
extern "C" int adam_apply(const int64_t* table, int n_leaves, int n_blocks,
                          int chunk, float lr_t, float d1, float d2, float wd,
                          float clip, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  adam_apply_kernel<<<n_blocks, 256, 0, (cudaStream_t)stream>>>(
      table, n_leaves, n_blocks, chunk, lr_t, d1, d2, wd, clip);
  return (int)cudaGetLastError();
}

extern "C" const char* adam_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
