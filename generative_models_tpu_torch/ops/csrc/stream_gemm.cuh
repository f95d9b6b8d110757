// The weight-streaming split-K GEMM for few rows on the tensor cores: the
// shared skeleton of Kernels G (masked_dense.cu) and J (int8.cu), and its
// s8 sibling for Kernel I (int8.cu; sg_gemm_s8, at the end).
//
//   out (M, N) f32 = bf16(x (M, K) f32) @ B (K, N), B staged to bf16 on chip
//
// Each kernel supplies its B operand as a policy (what it loads, how it is
// laid out, how it becomes bf16); x, the tiling, the pipeline, the products
// and the reduction are here.
//
//   * A block owns all 64 rows of an output strip of BN columns, so each
//     weight byte is read once at M <= 64; a larger M takes more 64-row
//     strips (grid z), rows past M are zero-filled in shared memory.
//   * K is split across `splits` blocks (grid x), each streaming `kper`
//     32-deep K tiles, so that few output strips still fill the card (two
//     blocks an SM, where 8 splits reach that). The
//     split is chosen in Python (ops/common.py plan_split_k) and checked
//     here: every K tile once, no empty split.
//   * The splits of one strip form a thread-block cluster (at most 8
//     blocks). Each block leaves its f32 partial sums in its own shared
//     memory, and after a cluster barrier each block adds a slice of the
//     strip over the cluster's blocks through distributed shared memory, in
//     rank order (split 0 + 1 + ...). Chosen over a scratch buffer and a
//     second pass: one launch, no device-memory round trip, and the order is
//     fixed, so the result is bitwise the same from run to run.
//   * K tiles stream through a ring of STAGES shared-memory stages with
//     cp.async, 16 bytes a copy, STAGES - 1 tiles in flight while one is
//     converted and multiplied. Where a row start is not 16-byte aligned
//     (VEC false: a K or N that is not a multiple of 16, or an operand not
//     16-byte aligned), the same ring is filled by plain loads.
//   * Each thread converts to bf16 exactly the bytes it copied itself (x
//     rounded to nearest even, B by its policy), into one of two bf16
//     tiles, so a stage needs no barrier before its conversion and one
//     after: at these shapes a tile's chain of barriers and dependent
//     shared-memory round trips, not its bytes, sets the pace (PERF.md).
//   * Every warp multiplies its 16 columns of the strip over all 64 rows
//     with mma.sync m16n8k16 (bf16 operands through ldmatrix, all of a
//     tile's fragments loaded before its products, f32 sums): 4 x 2 tiles,
//     32 sums a thread.
// Rows past M, columns past N and depth past K are zero-filled or not
// stored; nothing is padded in device memory.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

constexpr int SG_BM = 64;          // output rows a block (every path's M)
constexpr int SG_KT = 32;          // K a pipeline stage
constexpr int SG_MAX_SPLITS = 8;   // blocks a cluster, the portable limit
constexpr int SG_XLD = SG_KT + 8;  // bf16 row stride of the x tile: ldmatrix rows 80 bytes
                                   // apart, on distinct banks
constexpr int SG_X_RAW = SG_BM * SG_KT * 4;  // f32 x bytes a stage

// x (m0.., k0..) -> raw [SG_BM][SG_KT] f32, zero past M and K. Thread
// threadIdx.x owns items threadIdx.x + j * THREADS, 4 floats of a row each;
// sg_convert_x converts the same items.
template <bool VEC, int THREADS>
__device__ __forceinline__ void sg_load_x(float* raw, const float* __restrict__ x, int M, int K,
                                          int m0, int k0) {
  constexpr int CH = SG_KT / 4;  // items (16 bytes) a row
#pragma unroll
  for (int j = 0; j < SG_BM * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, kc = (i % CH) * 4;
    const int m = m0 + r, k = k0 + kc;
    float* dst = raw + r * SG_KT + kc;
    if (VEC) {
      const bool ok = m < M && k < K;
      gmt_cp_async16(dst, ok ? x + (size_t)m * K + k : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (m < M && k + e < K) ? x[(size_t)m * K + k + e] : 0.f;
    }
  }
}

// this thread's items of raw x -> xs [SG_BM][SG_XLD] bf16, rounded to
// nearest even (all loads first: stores to xs could alias them)
template <int THREADS>
__device__ __forceinline__ void sg_convert_x(const float* raw, __nv_bfloat16* xs) {
  constexpr int CH = SG_KT / 4, PER = SG_BM * CH / THREADS;
  float4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    v[j] = *reinterpret_cast<const float4*>(raw + (i / CH) * SG_KT + (i % CH) * 4);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    *reinterpret_cast<uint2*>(xs + (i / CH) * SG_XLD + (i % CH) * 4) =
        make_uint2(gmt_pack_bf16(v[j].x, v[j].y), gmt_pack_bf16(v[j].z, v[j].w));
  }
}

// Dynamic shared memory of sg_gemm<B, STAGES>: the ring of raw stages (its
// first bytes hold the partial sums at the end), then two pairs of bf16 x
// and B tiles.
template <class B, int STAGES>
constexpr size_t sg_smem_bytes() {
  static_assert(SG_BM * (B::BN + 4) * 4 <= STAGES * (SG_X_RAW + B::RAW),
                "the partial sums must fit in the ring");
  return (size_t)STAGES * (SG_X_RAW + B::RAW) + 2 * (SG_BM * SG_XLD + B::TILE) * 2;
}

// The kernel body. B (the policy) provides:
//   BN         output columns a block (16 a warp)
//   RAW        raw bytes of one stage of B
//   TILE, LD   bf16 elements of the staged tile, and its row stride
//   K_MAJOR    the tile is stored (n, k) (else (k, n))
//   load<VEC, THREADS>(raw, b, mask, K, N, k0, n0)   zero past K and N
//   convert<THREADS>(raw, bs)   the same thread's bytes that load copied
template <class B, bool VEC, int STAGES>
__device__ __forceinline__ void sg_gemm(const float* __restrict__ x,
                                        const typename B::Elem* __restrict__ b,
                                        const uint8_t* __restrict__ mask, float* __restrict__ out,
                                        int M, int K, int N, int kper) {
  namespace cg = cooperative_groups;
  constexpr int THREADS = B::BN / 16 * 32;
  constexpr int STAGE = SG_X_RAW + B::RAW;
  constexpr int PAIR = SG_BM * SG_XLD + B::TILE;  // bf16 elements of an (x, B) tile pair
  extern __shared__ __align__(16) unsigned char sg_smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(sg_smem + STAGES * STAGE);

  const int n0 = blockIdx.y * B::BN, m0 = blockIdx.z * SG_BM;
  const int kt0 = blockIdx.x * kper;  // this split's first K tile
  const int nt = max(0, min(kper, (K + SG_KT - 1) / SG_KT - kt0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = warp * 16;  // the warp's columns in the strip

  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the pipeline: tile t lives in stage t % STAGES and is converted into
  // tile pair t % 2; one commit group a tile (empty past nt), so
  // wait<STAGES - 2> at tile t means this thread's copies of tile t landed.
  // A thread refills a stage only with the bytes it converted from it.
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) {
      unsigned char* s = sg_smem + t * STAGE;
      const int k0 = (kt0 + t) * SG_KT;
      sg_load_x<VEC, THREADS>(reinterpret_cast<float*>(s), x, M, K, m0, k0);
      B::template load<VEC, THREADS>(s + SG_X_RAW, b, mask, K, N, k0, n0);
    }
    gmt_cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    gmt_cp_async_wait<STAGES - 2>();
    const int tn = t + STAGES - 1;
    if (tn < nt) {
      unsigned char* s = sg_smem + (tn % STAGES) * STAGE;
      const int k0 = (kt0 + tn) * SG_KT;
      sg_load_x<VEC, THREADS>(reinterpret_cast<float*>(s), x, M, K, m0, k0);
      B::template load<VEC, THREADS>(s + SG_X_RAW, b, mask, K, N, k0, n0);
    }
    gmt_cp_async_commit();
    const unsigned char* s = sg_smem + (t % STAGES) * STAGE;
    __nv_bfloat16* xs = tiles + (t % 2) * PAIR;
    __nv_bfloat16* bs = xs + SG_BM * SG_XLD;
    sg_convert_x<THREADS>(reinterpret_cast<const float*>(s), xs);
    B::template convert<THREADS>(s + SG_X_RAW, bs);
    // pair t % 2 complete; its last readers, tile t - 2's products, are
    // behind every thread's previous pass of this barrier
    __syncthreads();
    constexpr int KS = SG_KT / 16;
    unsigned bf[KS][4];     // (b0, b1) of the warp's two 8-column tiles
    unsigned af[KS][4][4];  // the four 16-row tiles of x
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = ks * 16;
      if (B::K_MAJOR)
        gmt_ldmatrix_x4(bf[ks], bs + (nw + lane % 8 + (lane / 16) * 8) * B::LD + kk +
                                    ((lane / 8) % 2) * 8);
      else
        gmt_ldmatrix_x4_trans(bf[ks], bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * B::LD +
                                          nw + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        gmt_ldmatrix_x4(af[ks][mt], xs + (mt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SG_XLD +
                                        kk + (lane / 16) * 8);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        gmt_mma_bf16(acc[mt][0], af[ks][mt], bf[ks][0], bf[ks][1]);
        gmt_mma_bf16(acc[mt][1], af[ks][mt], bf[ks][2], bf[ks][3]);
      }
  }
  gmt_cp_async_wait<0>();
  __syncthreads();  // every thread is past the ring: it holds the partial sums now

  constexpr int RLD = B::BN + 4;
  float* red = reinterpret_cast<float*>(sg_smem);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mt * 16 + lane / 4, c = nw + j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(red + r * RLD + c) = make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(red + (r + 8) * RLD + c) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }

  // the splits' sums in rank order: block `rank` of the cluster finishes
  // every splits-th group of THREADS float4 of the strip
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = gridDim.x;
  constexpr int ROW4 = B::BN / 4;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < SG_BM * ROW4; i += splits * THREADS) {
    const int r = i / ROW4, c = (i % ROW4) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    float4 p[SG_MAX_SPLITS];  // every rank's partial first, then the sums in rank order
#pragma unroll
    for (int q = 0; q < SG_MAX_SPLITS; ++q)
      if (q < splits)
        p[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + r * RLD + c);
    float4 v = p[0];
#pragma unroll
    for (int q = 1; q < SG_MAX_SPLITS; ++q)
      if (q < splits) {
        v.x += p[q].x;
        v.y += p[q].y;
        v.z += p[q].z;
        v.w += p[q].w;
      }
    const float vals[4] = {v.x, v.y, v.z, v.w};
    float* o = out + (size_t)m * N + n0 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < N) o[j] = vals[j];
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------- the s8 sibling (Kernel I)
//
//   out (M, N) s32 = x (M, K) s8 @ q (K, N) s8
//
// The same grid, split, cluster reduction and cp.async ring as sg_gemm, on
// the int8 tensor cores (mma.sync m16n8k32 s8, s32 sums): a stage is 64 deep
// in K (64 bytes of a row, the bytes of sg_gemm's 32-deep f32 x stage
// quartered), two m16n8k32 steps. x's (m, k) bytes are already the A
// operand's layout: they land by cp.async straight in a padded tile that
// ldmatrix reads. q is stored (K, N) row-major, but the B fragment wants four
// consecutive k of one column in a register, so each thread stages a 4 (k)
// x 16 (n) block of q raw, transposes it in registers (__byte_perm, four
// 4 x 4 byte transposes a 16-byte row) and stores it into an (n, k) tile of
// the same stage, which ldmatrix (non-.trans) reads. Integer sums are exact,
// so the result equals any other order's bitwise.
constexpr int SG8_KT = 64;            // K bytes a stage
constexpr int SG8_LD = SG8_KT + 16;   // row stride of the x and q^T tiles: 80 bytes,
                                      // ldmatrix rows on distinct banks

template <int BN>
struct Sg8Stage {  // byte offsets of one stage
  static constexpr int X = 0;                      // x (m, k): [SG_BM][SG8_LD]
  static constexpr int Q_RAW = SG_BM * SG8_LD;     // q (k, n) as copied: [SG8_KT][BN]
  static constexpr int QT = Q_RAW + SG8_KT * BN;   // q^T (n, k): [BN][SG8_LD]
  static constexpr int BYTES = QT + BN * SG8_LD;
  static constexpr int QBLOCKS = SG8_KT / 4 * (BN / 16);  // 4 x 16 blocks of q a stage
};

template <int BN, int STAGES>
constexpr size_t sg8_smem_bytes() {
  static_assert(SG_BM * (BN + 4) * 4 <= STAGES * Sg8Stage<BN>::BYTES,
                "the partial sums must fit in the ring");
  return (size_t)STAGES * Sg8Stage<BN>::BYTES;
}

// One stage's copies: x rows m0.., bytes k0.. (16-byte items, THREADS
// apart), and q's 4 x 16 blocks, block i owned by thread i * (THREADS /
// QBLOCKS); zero past M, K and N.
template <int BN, bool VEC, int THREADS>
__device__ __forceinline__ void sg8_load(unsigned char* st, const int8_t* __restrict__ x,
                                         const int8_t* __restrict__ q, int M, int K, int N,
                                         int m0, int k0, int n0) {
  using S = Sg8Stage<BN>;
  constexpr int CH = SG8_KT / 16;
#pragma unroll
  for (int j = 0; j < SG_BM * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, kc = (i % CH) * 16;
    const int m = m0 + r, k = k0 + kc;
    unsigned char* dst = st + S::X + r * SG8_LD + kc;
    if (VEC) {
      const bool ok = m < M && k < K;
      gmt_cp_async16(dst, ok ? x + (size_t)m * K + k : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (m < M && k + e < K) ? (unsigned char)x[(size_t)m * K + k + e] : 0;
    }
  }
  static_assert(THREADS % S::QBLOCKS == 0, "whole q blocks a thread");
  if (threadIdx.x % (THREADS / S::QBLOCKS)) return;
  const int b = threadIdx.x / (THREADS / S::QBLOCKS);
  const int kg = b / (BN / 16), c = (b % (BN / 16)) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * kg + i, k = k0 + r, n = n0 + c;
    unsigned char* dst = st + S::Q_RAW + r * BN + c;
    if (VEC) {
      const bool ok = k < K && n < N;
      gmt_cp_async16(dst, ok ? q + (size_t)k * N + n : q, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (k < K && n + e < N) ? (unsigned char)q[(size_t)k * N + n + e] : 0;
    }
  }
}

// this thread's q block of the stage, (k, n) -> (n, k): column n's four
// bytes of k 4 kg .. 4 kg + 3 become one word of q^T's row n
template <int BN, int THREADS>
__device__ __forceinline__ void sg8_transpose_q(unsigned char* st) {
  using S = Sg8Stage<BN>;
  if (threadIdx.x % (THREADS / S::QBLOCKS)) return;
  const int b = threadIdx.x / (THREADS / S::QBLOCKS);
  const int kg = b / (BN / 16), c = (b % (BN / 16)) * 16;
  uint4 rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    rows[i] = *reinterpret_cast<const uint4*>(st + S::Q_RAW + (4 * kg + i) * BN + c);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const unsigned r0 = (&rows[0].x)[w], r1 = (&rows[1].x)[w];
    const unsigned r2 = (&rows[2].x)[w], r3 = (&rows[3].x)[w];
    const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
    const unsigned t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
    const unsigned cols[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                              __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(st + S::QT + (c + 4 * w + j) * SG8_LD + 4 * kg) = cols[j];
  }
}

// The end of sg_gemm_s8, sg_gemm's reduction on s32 sums: each warp's
// 64 x 16 accumulator fragments (mma.cuh's C layout) go to red, this
// block's partial sums [SG_BM][BN + 4] in its own shared memory; after a
// cluster barrier each block finishes every splits-th group of THREADS
// 4-vectors of the strip, adding every rank's partial in rank order. The
// caller has drained its cp.async groups and passed a __syncthreads, so red
// may alias its ring.
template <int BN, int THREADS>
__device__ __forceinline__ void sg8_reduce(const int (&acc)[4][2][4], int* red,
                                           int* __restrict__ out, int M, int N, int m0, int n0) {
  namespace cg = cooperative_groups;
  using V2 = int2;
  using V4 = int4;
  using T = int;
  constexpr int RLD = BN + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = warp * 16;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mt * 16 + lane / 4, c = nw + j * 8 + 2 * (lane % 4);
      *reinterpret_cast<V2*>(red + r * RLD + c) = V2{acc[mt][j][0], acc[mt][j][1]};
      *reinterpret_cast<V2*>(red + (r + 8) * RLD + c) = V2{acc[mt][j][2], acc[mt][j][3]};
    }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = gridDim.x;
  constexpr int ROW4 = BN / 4;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < SG_BM * ROW4; i += splits * THREADS) {
    const int r = i / ROW4, c = (i % ROW4) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    V4 p[SG_MAX_SPLITS];  // every rank's partial first, then the sums in rank order
#pragma unroll
    for (int q = 0; q < SG_MAX_SPLITS; ++q)
      if (q < splits)
        p[q] = *reinterpret_cast<const V4*>(cluster.map_shared_rank(red, q) + r * RLD + c);
    V4 v = p[0];
#pragma unroll
    for (int q = 1; q < SG_MAX_SPLITS; ++q)
      if (q < splits) {
        v.x += p[q].x;
        v.y += p[q].y;
        v.z += p[q].z;
        v.w += p[q].w;
      }
    const T vals[4] = {v.x, v.y, v.z, v.w};
    T* o = out + (size_t)m * N + n0 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < N) o[j] = vals[j];
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int BN, bool VEC, int STAGES>
__device__ __forceinline__ void sg_gemm_s8(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ q, int* __restrict__ out,
                                           int M, int K, int N, int kper) {
  using S = Sg8Stage<BN>;
  constexpr int THREADS = BN / 16 * 32;
  extern __shared__ __align__(16) unsigned char sg_smem[];

  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * SG_BM;
  const int kt0 = blockIdx.x * kper;  // this split's first K stage
  const int nt = max(0, min(kper, (K + SG8_KT - 1) / SG8_KT - kt0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = warp * 16;  // the warp's columns in the strip

  int acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // tile t lives in stage t % STAGES; one commit group a tile (empty past
  // nt). Other warps read a stage's x and q^T, so a stage is refilled only
  // after the barrier that follows its last products: tile t + STAGES - 1
  // goes into tile t - 1's stage after tile t's barrier.
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt)
      sg8_load<BN, VEC, THREADS>(sg_smem + t * S::BYTES, x, q, M, K, N, m0,
                                 (kt0 + t) * SG8_KT, n0);
    gmt_cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    gmt_cp_async_wait<STAGES - 2>();
    unsigned char* st = sg_smem + (t % STAGES) * S::BYTES;
    sg8_transpose_q<BN, THREADS>(st);
    __syncthreads();  // tile t's x and q^T complete; tile t - 1's products done
    const int tn = t + STAGES - 1;
    if (tn < nt)
      sg8_load<BN, VEC, THREADS>(sg_smem + (tn % STAGES) * S::BYTES, x, q, M, K, N, m0,
                                 (kt0 + tn) * SG8_KT, n0);
    gmt_cp_async_commit();
    constexpr int KS = SG8_KT / 32;
    unsigned bf[KS][4];     // (b0, b1) of the warp's two 8-column tiles
    unsigned af[KS][4][4];  // the four 16-row tiles of x
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = ks * 32;
      gmt_ldmatrix_x4(bf[ks], st + S::QT + (nw + lane % 8 + (lane / 16) * 8) * SG8_LD + kk +
                                  ((lane / 8) % 2) * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        gmt_ldmatrix_x4(af[ks][mt], st + S::X + (mt * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                                    SG8_LD + kk + (lane / 16) * 16);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        gmt_mma_s8(acc[mt][0], af[ks][mt], bf[ks][0], bf[ks][1]);
        gmt_mma_s8(acc[mt][1], af[ks][mt], bf[ks][2], bf[ks][3]);
      }
  }
  gmt_cp_async_wait<0>();
  __syncthreads();  // every thread is past the ring: it holds the partial sums now
  sg8_reduce<BN, THREADS>(acc, reinterpret_cast<int*>(sg_smem), out, M, N, m0, n0);
}

// The checks every launcher makes: positive M and N, 1 <= splits <= 8,
// every kt-deep K tile in exactly one split and no split empty, and a grid
// within CUDA's limits.
inline bool sg_plan_ok(int M, int K, int N, int bn, int splits, int kper, int kt = SG_KT) {
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || splits > SG_MAX_SPLITS || kper < 1) return false;
  const long k_tiles = ((long)K + kt - 1) / kt;
  if ((long)splits * kper < k_tiles || (long)(splits - 1) * kper >= (k_tiles > 0 ? k_tiles : 1))
    return false;
  return (M + SG_BM - 1) / SG_BM <= 65535 && (N + bn - 1) / bn <= 65535;
}

inline bool sg_aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launch kernel over (splits, N / BN, M / 64) blocks, the splits of a strip
// as one cluster, with `smem` bytes of dynamic shared memory.
template <typename... KArgs, typename... Args>
inline cudaError_t sg_launch(void (*kernel)(KArgs...), int bn, int M, int N, int splits,
                             size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = gmt_allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + bn - 1) / bn, (M + SG_BM - 1) / SG_BM);
  cfg.blockDim = dim3(bn / 16 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}
