// SGD / NAG momentum apply over many f32 tensors in one launch, in place.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_optim.py:_sgd_kernel
// (pallas_call in _run, from fused_sgd_apply). Same function, per element
// of every leaf of one tag group: a NaN gradient becomes 0, the gradient is
// clipped to [-clip, clip] (clip != 0), wd * w is added (wd != 0), then
//   m' = momentum * m - lr * g
//   w' = w + m'                                  (sgd)
//   w' = w + (1 + momentum) * m' - momentum * m  (nag)
// in f32 with the rounded operations of the plain version (no contraction
// into an FMA). lr and momentum are arguments of every launch, so a
// schedule changes nothing that was built.
//
// Bound on the H100 (3.35 TB/s): w, g and m read once and w and m written
// once, 20 bytes per parameter: 0.22 GB, 0.067 ms, for Inception-BN's 11.3 M
// parameters over both groups.
//
// Design: the TPU kernel packed every leaf into one padded buffer and
// unpacked it after; here each leaf is read and written where it lives.
// The caller uploads a table of int64s: the w, g and m pointers and the
// size of each leaf, then for each CTA the leaf it works on and the first
// element of its chunk. A CTA updates up to `chunk` elements of one leaf
// in a grid-stride loop, neighbouring threads on neighbouring elements.
// Both groups of Inception-BN: 0.089 ms per launch of the whole set on an
// H100 80GB HBM3 at 700 W (chip_smoke.py).
#include "common.cuh"

__global__ void sgd_apply_kernel(const int64_t* __restrict__ table,
                                 int n_leaves, int n_blocks, int chunk,
                                 float lr, float momentum, float wd,
                                 float clip, int nag) {
  const int64_t leaf = table[4 * (int64_t)n_leaves + blockIdx.x];
  const int64_t start = table[4 * (int64_t)n_leaves + n_blocks + blockIdx.x];
  float* w = (float*)table[leaf];
  const float* g = (const float*)table[n_leaves + leaf];
  float* m = (float*)table[2 * n_leaves + leaf];
  const int64_t size = table[3 * n_leaves + leaf];
  const int64_t end = start + chunk < size ? start + chunk : size;
  const float one_plus = __fadd_rn(1.f, momentum);
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float wv = w[i];
    const float mv = m[i];
    float gv = g[i];
    if (gv != gv) gv = 0.f;
    if (clip != 0.f) gv = fminf(fmaxf(gv, -clip), clip);
    if (wd != 0.f) gv = __fadd_rn(gv, __fmul_rn(wd, wv));
    const float nm = __fsub_rn(__fmul_rn(momentum, mv), __fmul_rn(lr, gv));
    float nw;
    if (nag) {
      nw = __fsub_rn(__fadd_rn(wv, __fmul_rn(one_plus, nm)),
                     __fmul_rn(momentum, mv));
    } else {
      nw = __fadd_rn(wv, nm);
    }
    w[i] = nw;
    m[i] = nm;
  }
}

// table: device int64 array of 4 * n_leaves + 2 * n_blocks entries, laid
// out [w ptrs | g ptrs | m ptrs | sizes | CTA leaf | CTA chunk start].
// Returns a cudaError_t (0 = launched).
extern "C" int sgd_apply(const int64_t* table, int n_leaves, int n_blocks,
                         int chunk, float lr, float momentum, float wd,
                         float clip, int nag, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  sgd_apply_kernel<<<n_blocks, 256, 0, (cudaStream_t)stream>>>(
      table, n_leaves, n_blocks, chunk, lr, momentum, wd, clip, nag);
  return (int)cudaGetLastError();
}

extern "C" const char* sgd_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
