// The weight-streaming split-K GEMM for few rows on the tensor cores: the
// shared skeleton of Kernels G (masked_dense.cu) and J (int8.cu).
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

// The checks every launcher makes: positive M and N, 1 <= splits <= 8,
// every K tile in exactly one split and no split empty, and a grid within
// CUDA's limits.
inline bool sg_plan_ok(int M, int K, int N, int bn, int splits, int kper) {
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || splits > SG_MAX_SPLITS || kper < 1) return false;
  const long k_tiles = ((long)K + SG_KT - 1) / SG_KT;
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
