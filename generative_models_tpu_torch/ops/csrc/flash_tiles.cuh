// Warp-level tile routines of causal flash attention on the tensor cores,
// for sm_90a: Kernels C (attention.cu), E and D (attention_bwd.cu) and the
// ring's hop kernels K, L and M (ring_attention.cu) are built from them.
//
// A block stages (rows, D) bf16 tiles in shared memory with a row stride of
// DP + 8 elements (DP: D padded to a multiple of 16), so the 8 rows an
// ldmatrix reads lie 16 bytes apart in the banks and never conflict. A warp
// owns 16 rows of its own operand (q for the forward, q and dO for dQ, k
// and v for dK/dV) as mma A fragments in registers and walks the streamed
// tile 16 rows (a "chunk") at a time:
//   * ft_scores: S = A x tile^T over a chunk, one m16n8k16 product a
//     16-deep step and 8-column half (B by ldmatrix from the tile's rows,
//     no transpose);
//   * ft_split: the chunk's f32 accumulator fragments, which hold the
//     16 x 16 block in exactly the registers an A fragment needs (the two
//     n8 halves side by side), rounded into a bf16 pair hi = bf16(x),
//     lo = bf16(x - hi), so that hi + lo carries x to about 2^-16 relative;
//   * ft_accum: acc (16 x DP, f32) += hi x tile + lo x tile over the chunk
//     (B by ldmatrix.trans from the same rows).
// On these, one tile routine a job serves the flat kernel and its hop form
// alike: ft_fwd_tile (C, K), ft_dq_tile (E, L), ft_dkv_tile (D, M).
// Fragment maps: mma.cuh's header.
#pragma once

#include "common.cuh"
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

// the same in three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid): x to about 2^-26 relative, where a pair's 2^-18 is
// too coarse (an unnormalised sum compared element by element)
__device__ __forceinline__ void ft_split3(const float (&x)[2][4], unsigned (&p)[3][4]) {
  float r[2][4];  // x - hi
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      __nv_bfloat162 h = __floats2bfloat162_rn(x[j][e], x[j][e + 1]);
      const float2 hf = __bfloat1622float2(h);
      r[j][e] = x[j][e] - hf.x;
      r[j][e + 1] = x[j][e + 1] - hf.y;
      p[0][2 * j + e / 2] = *reinterpret_cast<unsigned*>(&h);  // ft_split's order
    }
  ft_split(r, p[1], p[2]);
}

// acc (16 x DP, f32) += (p[0] + .. + p[NP - 1]) (16 x 16) x tile[r0 ..
// r0 + 15] (16 x DP), the NP bf16 parts of a split (ft_split: hi, lo;
// ft_split3: hi, mid, lo): acc[n] is columns 8 n .. 8 n + 7, and each
// accumulator takes its parts' products in order. Up to DP = 64 every B
// fragment is loaded first, then every product of p[0], then of p[1], ..;
// at DP = 128, where the accumulators take the registers, each fragment is
// loaded just before its products.
template <int DP, int LD, int NP>
__device__ __forceinline__ void ft_accum(float (&acc)[DP / 8][4], const unsigned (&p)[NP][4],
                                         const __nv_bfloat16* tile, int r0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* row = tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
  if constexpr (DP > 64) {
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      unsigned b[4];
      gmt_ldmatrix_x4_trans(b, row + dn * 16);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        gmt_mma_bf16(acc[2 * dn], p[i], b[0], b[1]);
        gmt_mma_bf16(acc[2 * dn + 1], p[i], b[2], b[3]);
      }
    }
  } else {
    unsigned b[DP / 16][4];
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) gmt_ldmatrix_x4_trans(b[dn], row + dn * 16);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        gmt_mma_bf16(acc[2 * dn], p[i], b[dn][0], b[dn][1]);
        gmt_mma_bf16(acc[2 * dn + 1], p[i], b[dn][2], b[dn][3]);
      }
  }
}

// ------------------------------------------------------- the tile routines
//
// A query row r of the block's query chunk sees key kk of the key chunk
// where kk <= diag + r and kk < t_valid. diag is the query chunk's first
// global position less the key chunk's: 0 for the flat kernels, whose
// t_valid is T, and for a ring's diagonal hop. EDGE: the tile reaches past
// the block's diagonal or t_valid, so a warp skips a 16-row chunk that lies
// wholly past its rows (or t_valid) and masks the rest; an inner tile takes
// neither test, so its chunks are one straight run of code. In a flat
// kernel the t_valid tests only touch rows at or past T, which no kernel
// writes.

// The forward (C, K): one warp's online-softmax step on one K/V tile of
// SROWS keys (k0 ..) for its rows row0 .. row0 + 15, in log2 units (m the
// row max of S scale log2 e, l this lane's share of the row sum, sl2 =
// scale log2 e), then acc += P v with P as a hi/lo pair. A masked score is
// GMT_NEG_INF (finite, so m - m_new is never NaN). HOP, the ring's hop
// form: keys at or past t_valid are masked one by one (such a key can lie
// before a row by position; in the flat kernel causality masks every key
// past T for the rows it writes, and the test is left out), and P enters
// P v in three bf16 parts (ft_split3), because the hop's acc is an
// unnormalised sum held element by element to atol 2e-5 + rtol 2e-4, where
// a pair's error (up to ~4e-5 at the seq:4 ring's shape) misses it; the
// flat kernel's o is divided by l, and a pair holds it.
template <int DP, int SROWS, bool EDGE, bool HOP>
__device__ __forceinline__ void ft_fwd_tile(float (&acc)[DP / 8][4], float (&m)[2], float (&l)[2],
                                            const unsigned (&qa)[DP / 16][4],
                                            const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            int k0, int row0, int diag, int t_valid, float sl2) {
  constexpr int NC = SROWS / 16, KD = DP / 16, LD = DP + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  const int last = diag + row0;  // the last key the warp's first row sees
  float s[NC][2][4];
  float mx[2] = {GMT_NEG_INF, GMT_NEG_INF};
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int kc0 = k0 + 16 * cc;  // the chunk's first key
    if (EDGE && (kc0 > last + 15 || kc0 >= t_valid)) continue;
    ft_scores<KD, LD>(s[cc], qa, ks, 16 * cc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kc0 + 8 * j + c + (e & 1);
        if (EDGE && (key > last + g + 8 * (e / 2) || (HOP && key >= t_valid)))
          s[cc][j][e] = GMT_NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[cc][j][e]);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * sl2);
    const float alpha = ft_exp2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
  }
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int kc0 = k0 + 16 * cc;
    if (EDGE && (kc0 > last + 15 || kc0 >= t_valid)) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ft_exp2(fmaf(s[cc][j][e], sl2, -m[e / 2]));
        l[e / 2] += p;
        s[cc][j][e] = p;
      }
    unsigned pp[HOP ? 3 : 2][4];
    if constexpr (HOP)
      ft_split3(s[cc], pp);
    else
      ft_split(s[cc], pp[0], pp[1]);
    ft_accum<DP, LD, HOP ? 3 : 2>(acc, pp, vs, 16 * cc);
  }
}

// dQ (E, L): one warp's work on one K/V tile of SROWS keys (k0 ..): over
// each 16-key chunk, P and dS of the warp's rows row0 .. row0 + 15 (lg:
// their lse log2 e, dl: their delta), then acc += dS k, dS as a hi/lo pair.
template <int DP, int SROWS, bool EDGE>
__device__ __forceinline__ void ft_dq_tile(float (&acc)[DP / 8][4],
                                           const unsigned (&qa)[DP / 16][4],
                                           const unsigned (&doa)[DP / 16][4],
                                           const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                           int k0, int row0, int diag, int t_valid, float sl2,
                                           const float (&lg)[2], const float (&dl)[2]) {
  constexpr int KD = DP / 16, LD = DP + 8;
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  const int last = diag + row0;
#pragma unroll
  for (int cc = 0; cc < SROWS / 16; ++cc) {
    const int kc0 = k0 + 16 * cc;  // the chunk's first key
    if (EDGE && (kc0 > last + 15 || kc0 >= t_valid)) continue;
    float s[2][4], dp[2][4];
    ft_scores<KD, LD>(s, qa, ks, 16 * cc);
    ft_scores<KD, LD>(dp, doa, vs, 16 * cc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, key = kc0 + 8 * j + c + (e & 1);
        float p = ft_exp2(fmaf(s[j][e], sl2, -lg[h]));
        if (EDGE && (key > last + g + 8 * h || key >= t_valid)) p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]);  // dS
      }
    unsigned pp[2][4];
    ft_split(s, pp[0], pp[1]);
    ft_accum<DP, LD, 2>(acc, pp, ks, 16 * cc);
  }
}

// dK/dV (D, M): one warp's work on one 16-query chunk (queries q0 + 16 cc
// .., of a tile whose lse and delta are in ls and dls): the transposed P^T
// and dS^T of the warp's keys (rows kr0 .. of the block's k and v tiles, as
// A fragments ka and va, re-read each chunk at DP > 64 where the
// accumulators take the registers), then dV += P^T dO and dK += dS^T Q,
// each a hi/lo pair. first: the first query that sees the warp's first
// key. Only queries are tested against t_valid: keys at or past it are
// the caller's to drop (each key's sums are its own rows of dK and dV).
template <int DP, bool EDGE>
__device__ __forceinline__ void ft_dkv_chunk(float (&dka)[DP / 8][4], float (&dva)[DP / 8][4],
                                             unsigned (&ka)[DP / 16][4],
                                             unsigned (&va)[DP / 16][4],
                                             const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                             const __nv_bfloat16* qs, const __nv_bfloat16* dos,
                                             const float* ls, const float* dls, int q0, int cc,
                                             int first, int kr0, int t_valid, float sl2) {
  constexpr int KD = DP / 16, LD = DP + 8;
  constexpr float LOG2E = 1.4426950408889634f;
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  const int qc0 = q0 + 16 * cc;  // the chunk's first query
  if (EDGE && (qc0 + 15 < first || qc0 >= t_valid)) return;
  float s[2][4], dp[2][4];  // S^T and dP^T: (key, query)
  if constexpr (DP > 64) ft_a_frags<KD, LD>(ka, ks, kr0);
  ft_scores<KD, LD>(s, ka, qs, 16 * cc);
  if constexpr (DP > 64) ft_a_frags<KD, LD>(va, vs, kr0);
  ft_scores<KD, LD>(dp, va, dos, 16 * cc);
  float p[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = 16 * cc + 8 * j + c;  // the thread's first query of the half, in the tile
    const float2 l2 = *reinterpret_cast<const float2*>(ls + qi);
    const float2 d2 = *reinterpret_cast<const float2*>(dls + qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 1) ? l2.y : l2.x, dlv = (e & 1) ? d2.y : d2.x;
      float pe = ft_exp2(fmaf(s[j][e], sl2, -lv * LOG2E));
      if (EDGE && q0 + qi + (e & 1) < first + g + 8 * (e / 2)) pe = 0.f;
      p[j][e] = pe;
      s[j][e] = pe * (dp[j][e] - dlv);  // dS^T
    }
  }
  unsigned pp[2][4];
  ft_split(p, pp[0], pp[1]);
  ft_accum<DP, LD, 2>(dva, pp, dos, 16 * cc);
  ft_split(s, pp[0], pp[1]);
  ft_accum<DP, LD, 2>(dka, pp, qs, 16 * cc);
}

// ft_dkv_chunk over the SROWS / 16 chunks of one Q/dO tile (queries q0 ..)
// for the warp's keys key0 .. key0 + 15
template <int DP, int SROWS, bool EDGE>
__device__ __forceinline__ void ft_dkv_tile(float (&dka)[DP / 8][4], float (&dva)[DP / 8][4],
                                            unsigned (&ka)[DP / 16][4],
                                            unsigned (&va)[DP / 16][4],
                                            const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            const __nv_bfloat16* qs, const __nv_bfloat16* dos,
                                            const float* ls, const float* dls, int q0, int key0,
                                            int kr0, int diag, int t_valid, float sl2) {
  const int first = key0 - diag;
  if constexpr (DP > 64) {
    // one chunk at a time: unrolled, two chunks' work interleaves past the
    // 255 registers a thread has, and spills
#pragma unroll 1
    for (int cc = 0; cc < SROWS / 16; ++cc)
      ft_dkv_chunk<DP, EDGE>(dka, dva, ka, va, ks, vs, qs, dos, ls, dls, q0, cc, first, kr0,
                             t_valid, sl2);
  } else {
#pragma unroll
    for (int cc = 0; cc < SROWS / 16; ++cc)
      ft_dkv_chunk<DP, EDGE>(dka, dva, ka, va, ks, vs, qs, dos, ls, dls, q0, cc, first, kr0,
                             t_valid, sl2);
  }
}
