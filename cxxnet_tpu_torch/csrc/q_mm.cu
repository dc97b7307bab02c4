// int8 x int8 -> int32 matrix product with the dequant, bias and relu
// epilogue fused: y = act(float(xq @ wq) * factor + bias), per group.
//
// Replaces the TPU kernel cxxnet_tpu/ops/fused_quant.py:_q_mm_kernel
// (pallas_call in _q_mm_pallas). Same function: xq int8 (M, K) against the
// int8 weight, an int32 accumulator, then per output column n the f32
// epilogue. The epilogue rounds twice, as the port's plain version
// (ops/fused_quant.q_mm_plain) does: __int2float_rn(acc), __fmul_rn by
// factor[n], __fadd_rn of bias[n], then relu; so the two are bit-equal
// on the card. (Compiled XLA contracts acc * factor + bias into one FMA;
// against the JAX package the difference is one f32 rounding.)
//
// Layouts, as the wrapper hands them: A is (M, G*K) row-major, group g
// reading columns [g*K, (g+1)*K) (the int8 im2col of a grouped conv, or
// the quantized rows of a fullc with G = 1); B is (G*N, K) row-major, the
// weight transposed so that K is contiguous (group g its rows
// [g*N, (g+1)*N)); factor and bias are (G*N,) f32 (bias may be NULL); y
// is (M, G*N) f32, group g writing its columns [g*N, (g+1)*N). So one
// launch covers every group of a layer: the group is the grid's z.
//
// Bound on the H100: the larger of 2*M*N*K*G operations at the int8
// tensor cores' 1,979 TOPS and the bytes (A and B once, y, factor and
// bias) at 3.35 TB/s. fc6 at M 32 (K 9216, N 4096) reads 37.7 MB of
// weight: 11.3 us. conv1 as im2col at bucket 32 (M 401,408, K 147, N 64):
// 59 MB of A and 103 MB of y, about 48 us.
//
// Design (a simple kernel that is right; wgmma, TMA and a pipelined
// mainloop are later work): 128 x 64 output tiles, 256 threads as 4 x 2
// warps of 32 x 32, K in steps of 64 staged in shared memory (rows padded
// to 80 bytes: 16-byte aligned and free of bank conflicts for the
// fragment reads), the product by mma.sync m16n8k32 s8 (int32
// accumulators in registers). Any M, K, N: rows, columns and the K tail
// outside the matrices are zero-filled in shared memory. When K is a
// multiple of 16 and the bases are 16-byte aligned the tiles are copied
// 16 bytes a thread; otherwise (conv1's K = 147) 4 bytes gathered one by
// one.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int PITCH = BK + 16;   // bytes per staged row
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [0, ROWS) x columns [k0, k0 + BK) of the matrix at g (row
// stride ld, `rows` rows and K columns valid) into sm, zeros outside.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage(int8_t* __restrict__ sm,
                                      const int8_t* __restrict__ g,
                                      int64_t ld, int rows, int k0, int K) {
  if (VEC) {
    constexpr int CHUNKS = ROWS * (BK / 16);
    for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
      const int r = c / (BK / 16), kk = (c % (BK / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && k0 + kk < K)
        v = *reinterpret_cast<const uint4*>(g + r * ld + k0 + kk);
      *reinterpret_cast<uint4*>(sm + r * PITCH + kk) = v;
    }
  } else {
    constexpr int WORDS = ROWS * (BK / 4);
    for (int c = threadIdx.x; c < WORDS; c += THREADS) {
      const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
      unsigned v = 0u;
      if (r < rows) {
        const int8_t* p = g + r * ld + k0 + kk;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + kk + j < K) v |= ((unsigned)(uint8_t)p[j]) << (8 * j);
      }
      *reinterpret_cast<unsigned*>(sm + r * PITCH + kk) = v;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
q_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            const float* __restrict__ factor, const float* __restrict__ bias,
            float* __restrict__ Y, int M, int K, int N, int G, int relu) {
  __shared__ __align__(16) int8_t sA[BM * PITCH];
  __shared__ __align__(16) int8_t sB[BN * PITCH];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, grp = blockIdx.z;
  const int64_t lda = (int64_t)G * K, ldy = (int64_t)G * N;
  const int8_t* a_blk = A + (int64_t)m0 * lda + (int64_t)grp * K;
  const int8_t* b_blk = B + ((int64_t)grp * N + n0) * K;
  const int rows_a = min(BM, M - m0), rows_b = min(BN, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gid = lane / 4, tig = lane % 4;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();                       // the last step's reads are done
    stage<BM, VEC>(sA, a_blk, lda, rows_a, k0, K);
    stage<BN, VEC>(sB, b_blk, K, rows_b, k0, K);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = sA + (wm + i * 16 + gid) * PITCH + ks + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sB + (wn + j * 8 + gid) * PITCH + ks + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // epilogue: c0, c1 at row gid, c2, c3 at row gid + 8; columns 2*tig, +1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + gid + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + tig * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const int64_t n = (int64_t)grp * N + col;
        float v = __fmul_rn(__int2float_rn(acc[i][j][r]), factor[n]);
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        if (relu) v = relu_f32(v);
        Y[(int64_t)row * ldy + n] = v;
      }
}

}  // namespace

// a: (M, G*K) int8; b: (G*N, K) int8; factor: (G*N,) f32; bias: (G*N,)
// f32 or NULL; y: (M, G*N) f32; all contiguous. Returns a cudaError_t (0 =
// launched).
extern "C" int q_mm(const void* a, const void* b, const void* factor,
                    const void* bias, void* y, int M, int K, int N, int G,
                    int relu, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, G);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && ((uintptr_t)a % 16) == 0 &&
                   ((uintptr_t)b % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    q_mm_kernel<true><<<grid, THREADS, 0, s>>>(
        (const int8_t*)a, (const int8_t*)b, (const float*)factor,
        (const float*)bias, (float*)y, M, K, N, G, relu);
  else
    q_mm_kernel<false><<<grid, THREADS, 0, s>>>(
        (const int8_t*)a, (const int8_t*)b, (const float*)factor,
        (const float*)bias, (float*)y, M, K, N, G, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* q_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
