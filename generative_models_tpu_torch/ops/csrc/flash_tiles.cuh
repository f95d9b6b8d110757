// Warp-level tile routines of the causal flash-attention backward on the
// tensor cores, for sm_90a: Kernels D and E (attention_bwd.cu) are built
// from them, and they are kept apart so that the ring's hop kernels can be.
//
// A block stages (rows, D) bf16 tiles in shared memory with a row stride of
// DP + 8 elements (DP: D padded to a multiple of 16), so the 8 rows an
// ldmatrix reads lie 16 bytes apart in the banks and never conflict. A warp
// owns 16 rows of its own operand (q and dO for dQ, k and v for dK/dV) as
// mma A fragments in registers and walks the streamed tile 16 rows (a
// "chunk") at a time:
//   * ft_scores: S = A x tile^T over a chunk, one m16n8k16 product a
//     16-deep step and 8-column half (B by ldmatrix from the tile's rows,
//     no transpose);
//   * ft_split: the chunk's f32 accumulator fragments, which hold the
//     16 x 16 block in exactly the registers an A fragment needs (the two
//     n8 halves side by side), rounded into a bf16 pair hi = bf16(x),
//     lo = bf16(x - hi), so that hi + lo carries x to about 2^-16 relative;
//   * ft_accum: acc (16 x DP, f32) += hi x tile + lo x tile over the chunk
//     (B by ldmatrix.trans from the same rows).
// Fragment maps: mma.cuh's header.
#pragma once

#include "mma.cuh"

// rows r0 .. r0 + ROWS - 1 of a (T, D) bf16 matrix -> tile [ROWS][DP + 8]
// in shared memory, 16 bytes a cp.async (D a multiple of 8, src 16-byte
// aligned); rows past T and columns past D are zero-filled. Every thread
// takes ROWS * DP / 8 / THREADS copies; the caller commits.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void ft_load_tile(__nv_bfloat16* tile,
                                             const __nv_bfloat16* __restrict__ src, int r0,
                                             int T, int D) {
  constexpr int CH = DP / 8, LD = DP + 8;
  static_assert(ROWS * CH % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, col = (i % CH) * 8;
    const bool ok = r0 + r < T && col < D;
    gmt_cp_async16(tile + r * LD + col, ok ? src + (size_t)(r0 + r) * D + col : src, ok);
  }
}

// entries r0 .. r0 + ROWS - 1 of an f32 row of length T -> dst[ROWS],
// 4 bytes a cp.async (the row need not be 16-byte aligned); zero past T
template <int ROWS, int THREADS>
__device__ __forceinline__ void ft_load_row(float* dst, const float* __restrict__ src, int r0,
                                            int T) {
#pragma unroll
  for (int j = 0; j < (ROWS + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (ROWS % THREADS == 0 || i < ROWS) {
      const bool ok = r0 + i < T;
      gmt_cp_async4(dst + i, ok ? src + r0 + i : src, ok);
    }
  }
}

// A fragments of tile rows r0 .. r0 + 15, all DP columns (KD = DP / 16
// steps of 16)
template <int KD, int LD>
__device__ __forceinline__ void ft_a_frags(unsigned (&a)[KD][4], const __nv_bfloat16* tile,
                                           int r0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    gmt_ldmatrix_x4(a[kd], tile + (r0 + lane % 16) * LD + kd * 16 + (lane / 16) * 8);
}

// s = a (16 x DP) x tile[c0 .. c0 + 15]^T: s[j] is columns c0 + 8 j .. + 7
template <int KD, int LD>
__device__ __forceinline__ void ft_scores(float (&s)[2][4], const unsigned (&a)[KD][4],
                                          const __nv_bfloat16* tile, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  unsigned b[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    gmt_ldmatrix_x4(b[kd], tile + (c0 + lane % 8 + (lane / 16) * 8) * LD + kd * 16 +
                               ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    gmt_mma_bf16(s[0], a[kd], b[kd][0], b[kd][1]);
    gmt_mma_bf16(s[1], a[kd], b[kd][2], b[kd][3]);
  }
}

// 2^x on the special-function unit (ex2.approx: ~2 ulp; results below
// 2^-126 are flushed to 0)
__device__ __forceinline__ float ft_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each a packed pair
__device__ __forceinline__ void ft_split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// a chunk's accumulator fragments (16 rows x 16 columns, ft_scores' layout)
// -> the A fragments of its hi and lo bf16 parts
__device__ __forceinline__ void ft_split(const float (&x)[2][4], unsigned (&hi)[4],
                                         unsigned (&lo)[4]) {
  ft_split2(x[0][0], x[0][1], hi[0], lo[0]);  // (g, c..c+1)
  ft_split2(x[0][2], x[0][3], hi[1], lo[1]);  // (g+8, c..c+1)
  ft_split2(x[1][0], x[1][1], hi[2], lo[2]);  // (g, c+8..c+9)
  ft_split2(x[1][2], x[1][3], hi[3], lo[3]);  // (g+8, c+8..c+9)
}

// acc (16 x DP, f32) += (hi + lo) (16 x 16) x tile[r0 .. r0 + 15] (16 x DP):
// acc[n] is columns 8 n .. 8 n + 7; every hi product, then every lo one
template <int DP, int LD>
__device__ __forceinline__ void ft_accum(float (&acc)[DP / 8][4], const unsigned (&hi)[4],
                                         const unsigned (&lo)[4], const __nv_bfloat16* tile,
                                         int r0) {
  const int lane = threadIdx.x % 32;
  unsigned b[DP / 16][4];
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn)
    gmt_ldmatrix_x4_trans(b[dn], tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dn * 16 +
                                     (lane / 16) * 8);
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
    gmt_mma_bf16(acc[2 * dn], hi, b[dn][0], b[dn][1]);
    gmt_mma_bf16(acc[2 * dn + 1], hi, b[dn][2], b[dn][3]);
  }
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
    gmt_mma_bf16(acc[2 * dn], lo, b[dn][0], b[dn][1]);
    gmt_mma_bf16(acc[2 * dn + 1], lo, b[dn][2], b[dn][3]);
  }
}
