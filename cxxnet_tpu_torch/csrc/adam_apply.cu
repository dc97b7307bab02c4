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
// Design: a small launch is latency, not bytes, so every thread has all of
// its loads in flight at once and the CTAs fill the card. The caller
// uploads one table of int64s (ops/fused_optim.adam_table): the w, g, m1
// and m2 pointers of each leaf, then for each CTA the first element of its
// chunk and a word holding its leaf, its element count and whether it is
// vectorised. A CTA takes up to 4 * kAdamThreads = 1024 elements of one leaf
// (the LM's 213 k wmat parameters make 208 CTAs): in a vectorised chunk,
// whose four streams start on a 16-byte boundary, each thread one 16-byte
// vector of w, g, m1 and m2 (a partial vector at a leaf's end element by
// element); in any other chunk (a leaf's head before its first boundary,
// or a leaf whose four bases sit apart from it) up to 4 single elements a
// thread, kAdamThreads apart. A thread issues all of its loads before its
// first store, so the table's pointers, which may alias for all the
// compiler knows, serialise nothing. On an NVIDIA H100 80GB HBM3 at
// 700.00 W (chip_smoke.py --ab) all 21 of the LM's leaves in one launch
// take 2.93-3.01 us, and Inception-BN's 11.3 M parameters 0.1099-0.1101
// ms (2.87 TB/s); the design it replaced (8192-element CTAs, 32 scalar
// iterations a thread, each iteration's loads behind the last one's
// stores) took 10.76-10.84 us and 0.1193-0.1194 ms in the same call.
#include "common.cuh"

constexpr int kAdamThreads = 256;  // a CTA's elements: 4 * kAdamThreads

struct AdamArgs {
  float lr_t, d1, d2, wd, clip;
};

// One element's update: w, m1 and m2 in place from the gradient g
__device__ __forceinline__ void adam_elem(float& w, float g, float& m1,
                                          float& m2, const AdamArgs& a) {
  if (g != g) g = 0.f;
  if (a.clip != 0.f) g = fminf(fmaxf(g, -a.clip), a.clip);
  if (a.wd != 0.f) g = __fadd_rn(g, __fmul_rn(a.wd, w));
  m1 = __fadd_rn(m1, __fmul_rn(a.d1, __fsub_rn(g, m1)));
  m2 = __fadd_rn(m2, __fmul_rn(a.d2, __fsub_rn(__fmul_rn(g, g), m2)));
  const float den = __fadd_rn(__fsqrt_rn(m2), 1e-8f);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(a.lr_t, m1), den));
}

__global__ void __launch_bounds__(kAdamThreads)
    adam_apply_kernel(const int64_t* __restrict__ table, int n_leaves,
                      int n_blocks, AdamArgs a) {
  const int64_t start = table[4 * (int64_t)n_leaves + blockIdx.x];
  const int64_t meta = table[4 * (int64_t)n_leaves + n_blocks + blockIdx.x];
  const int leaf = (int)(meta >> 32);
  const int count = (int)((meta & 0xffffffff) >> 1);
  float* w = (float*)table[leaf] + start;
  const float* g = (const float*)table[n_leaves + leaf] + start;
  float* m1 = (float*)table[2 * n_leaves + leaf] + start;
  float* m2 = (float*)table[3 * n_leaves + leaf] + start;
  const int t = threadIdx.x;
  if ((meta & 1) && 4 * t + 4 <= count) {
    float4 wv = reinterpret_cast<const float4*>(w)[t];
    const float4 gv = reinterpret_cast<const float4*>(g)[t];
    float4 av = reinterpret_cast<const float4*>(m1)[t];
    float4 bv = reinterpret_cast<const float4*>(m2)[t];
    adam_elem(wv.x, gv.x, av.x, bv.x, a);
    adam_elem(wv.y, gv.y, av.y, bv.y, a);
    adam_elem(wv.z, gv.z, av.z, bv.z, a);
    adam_elem(wv.w, gv.w, av.w, bv.w, a);
    reinterpret_cast<float4*>(w)[t] = wv;
    reinterpret_cast<float4*>(m1)[t] = av;
    reinterpret_cast<float4*>(m2)[t] = bv;
    return;
  }
  // element k of this thread: 4t + k of a vectorised chunk's partial
  // vector, or t + k * kAdamThreads of any other chunk
  const int first = (meta & 1) ? 4 * t : t;
  const int step = (meta & 1) ? 1 : kAdamThreads;
  float wv[4], gv[4], av[4], bv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = first + k * step;
    if (i < count) {
      wv[k] = w[i];
      gv[k] = g[i];
      av[k] = m1[i];
      bv[k] = m2[i];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = first + k * step;
    if (i < count) {
      adam_elem(wv[k], gv[k], av[k], bv[k], a);
      w[i] = wv[k];
      m1[i] = av[k];
      m2[i] = bv[k];
    }
  }
}

// table: device int64 array of 4 * n_leaves + 2 * n_blocks entries, laid
// out [w ptrs | g ptrs | m1 ptrs | m2 ptrs | CTA chunk start | CTA word:
// leaf << 32 | count << 1 | vectorised], as ops/fused_optim.adam_table
// writes it. Returns a cudaError_t (0 = launched).
extern "C" int adam_apply(const int64_t* table, int n_leaves, int n_blocks,
                          float lr_t, float d1, float d2, float wd,
                          float clip, void* stream) {
  if (n_leaves <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  adam_apply_kernel<<<n_blocks, kAdamThreads, 0, (cudaStream_t)stream>>>(
      table, n_leaves, n_blocks, AdamArgs{lr_t, d1, d2, wd, clip});
  return (int)cudaGetLastError();
}

extern "C" const char* adam_apply_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
