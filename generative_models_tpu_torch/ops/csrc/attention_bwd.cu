// Kernels D and E: causal flash-attention backward on the tensor cores, for
// sm_90a.
//
// Replaces: generative_models_tpu/ops/attention.py _flash_bwd_kernel (:209,
// called by _flash_backward :244), _flash_bwd_dq_streamed (:389) and
// _flash_bwd_dkv_streamed (:418, both called by _flash_backward_streamed
// :454). The TPU kernel carried dK/dV from one grid step to the next in
// VMEM; Hopper runs blocks in no order, so this is the FlashAttention-2
// split: one kernel owns the query rows (dQ), the other the key rows (dK,
// dV). Neither needs atomics, and every sum runs in a fixed order, so two
// launches on the same inputs give bitwise the same gradients. One plan
// covers every T.
//
// Inputs: q, k, v, dO (BH, T, D) bf16 (dO rounded to the operand type, as
// the JAX package rounds it), o (BH, T, D) f32 and lse (BH, T) f32 from
// Kernel C. P = exp(q k^T * scale - lse), recomputed; dP = dO v^T;
// dS = P * (dP - delta) with delta = rowsum(dO * o); dQ = dS k * scale,
// dK = dS^T q * scale, dV = P^T dO, all f32.
//
// P and dS as bf16 pairs: a tensor-core product takes bf16 operands, and
// the TPU kernel rounds P and dS to bf16 once before its dQ/dK/dV
// products. That moves the gradients by up to ~6e-3 at T=784, far past the
// port's contract (atol 1e-4 + rtol 1e-3 against the plain version, which
// keeps P and dS in f32; tests/test_torch_attention_bwd.py pins it). So
// each is split in registers into hi = bf16(x) and lo = bf16(x - hi), and
// both products are summed in f32: one extra product for E (four in all)
// and two for D (six), and P and dS stay good to ~2^-16 relative.
//
// What bounds it on an H100: at the pixel_transformer training shape
// (BH=256, T=784, D=32) each kernel moves ~104 MB (each input read once,
// each output written once; ~0.031 ms at 3.35 TB/s) against 20 GFLOP (E:
// four products) or 30 GFLOP (D: six) over the ~79M live (query, key)
// pairs (~0.020 and ~0.031 ms at the bf16 tensor-core peak), and ~95M exp
// a kernel on the special-function units. mma.sync does not reach that
// peak on Hopper (wgmma does), and each 16 x 16 chunk of a warp is one
// dependent chain (fragments, S and dP, exp, split, products), so in
// practice the products' issue rate and the chain's latency set the pace
// (PERF.md). The design:
//   * E (flash_bwd_dq_kernel) runs first: one block of four warps per (bh,
//     64-row query tile), tiles issued longest-first as in Kernel C. Each
//     warp owns 16 query rows, q and dO as mma A fragments in registers.
//     While its first copies fly, the prologue forms delta = rowsum(dO * o)
//     from the f32 o (two threads a row, every load issued at once) and
//     writes it out for D. K and V tiles of 64 keys (32 at D > 64, where
//     the accumulators take the registers) stream from key 0 to the
//     diagonal.
//   * D (flash_bwd_dkv_kernel): one block of four warps per (bh, 64-key
//     tile), first tiles first (they see the most queries); each warp owns
//     16 keys, k and v as A fragments (at D > 64 re-read from shared memory
//     each chunk). Q and dO tiles of 64 queries (32 at D > 64), with their
//     lse and delta, stream from the diagonal to T. It forms the transposed
//     tiles directly, S^T = k Q^T and dP^T = v dO^T, so that P^T and dS^T
//     are A fragments of dV += P^T dO and dK += dS^T Q: nothing is
//     transposed through memory.
//   * The streamed tiles come in by 16-byte cp.async into a double-buffered
//     ring, one barrier a tile: the next tile's copies fly while the warps
//     multiply this one. flash_tiles.cuh holds the warp-level routines.
//   * Only a tile that reaches the block's diagonal (or T) takes the
//     tests: there a warp skips a 16-row chunk that lies wholly past the
//     diagonal (or past T) and masks the rest; every other tile runs its
//     chunks as one straight, unmasked run of code. Rows and keys past T and
//     the columns from D to the next multiple of 16 load as zeros: a query
//     row past T has q = dO = 0 and lse = delta = 0, so P = 1 and dS = 0
//     there and it adds exactly 0 to dV and dK; a key past T is masked by
//     causality. T needs no padding and no copies.
//   * D is padded to a bucket (16, 32, 64, 128) at compile time.

#include "common.cuh"
#include "flash_tiles.cuh"

constexpr int BWD_ROWS = 64;      // query rows (E) or keys (D) a block, 16 a warp
constexpr int BWD_THREADS = 128;  // four warps
constexpr float BWD_LOG2E = 1.4426950408889634f;

// The tiling of one D bucket: the streamed tiles hold SROWS keys (E) or
// queries (D), 32 at DP = 128 where the accumulators take the registers.
// At DP = 32, every path's width, each kernel is held to the registers
// that let MINB blocks share an SM (E 6, D 5, so 80 and 102 registers):
// a block's chunks run as one dependent chain, and more warps to switch
// between hide its latency better than more registers help one warp
// (PERF.md section 6). The other buckets take what ptxas gives them.
template <int DP>
struct BwdPlan {
  static constexpr int SROWS = DP > 64 ? 32 : 64;
  static constexpr int LD = DP + 8, KD = DP / 16, STILE = SROWS * LD;
  static constexpr int MINB_E = DP == 32 ? 6 : 1, MINB_D = DP == 32 ? 5 : 1;
  // E: its own q and dO tiles, two stages of (K, V), then delta of its rows
  static constexpr size_t DQ_SMEM = (size_t)(2 * BWD_ROWS * LD + 4 * STILE) * 2 + BWD_ROWS * 4;
  // D: its own k and v tiles, two stages of (Q, dO), then two of (lse, delta)
  static constexpr size_t DKV_SMEM =
      (size_t)(2 * BWD_ROWS * LD + 4 * STILE) * 2 + 4 * SROWS * 4;
};

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, BwdPlan<DP>::MINB_E) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int T, int D, float scale) {
  using P = BwdPlan<DP>;
  constexpr int LD = P::LD, BKV = P::SROWS, TILE = P::STILE;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dos = qs + BWD_ROWS * LD;
  __nv_bfloat16* ring = dos + BWD_ROWS * LD;  // stage s: K at ring + 2 s TILE, V after it
  float* dls = reinterpret_cast<float*>(ring + 4 * TILE);
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_ROWS;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const size_t base = (size_t)bh * T * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int n_tiles = (min(T, q0 + BWD_ROWS) + BKV - 1) / BKV;

  ft_load_tile<BWD_ROWS, DP, BWD_THREADS>(qs, q + base, q0, T, D);
  ft_load_tile<BWD_ROWS, DP, BWD_THREADS>(dos, dout + base, q0, T, D);
  ft_load_tile<BKV, DP, BWD_THREADS>(ring, kb, 0, T, D);
  ft_load_tile<BKV, DP, BWD_THREADS>(ring + TILE, vb, 0, T, D);
  gmt_cp_async_commit();

  // while the copies fly: delta = rowsum(dO * o), two threads a row, each
  // over half of D (a multiple of 4), all loads issued together
  {
    const int r = threadIdx.x / 2, row = q0 + r, d0 = (threadIdx.x % 2) * (D / 2);
    float s = 0.f;
    if (row < T) {
      const float* orow = o + base + (size_t)row * D + d0;
      const __nv_bfloat16* drow = dout + base + (size_t)row * D + d0;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (4 * j < D / 2) {
          const float4 ov = *reinterpret_cast<const float4*>(orow + 4 * j);
          const uint2 dv2 = *reinterpret_cast<const uint2*>(drow + 4 * j);
          const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv2.x));
          const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv2.y));
          s = fmaf(d01.x, ov.x, s);
          s = fmaf(d01.y, ov.y, s);
          s = fmaf(d23.x, ov.z, s);
          s = fmaf(d23.y, ov.w, s);
        }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (threadIdx.x % 2 == 0) {
      dls[r] = s;
      if (row < T) delta[(size_t)bh * T + row] = s;
    }
  }
  // lse * log2(e) of this thread's rows g and g + 8 (0 past T)
  float lg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    lg[h] = row < T ? lse[(size_t)bh * T + row] * BWD_LOG2E : 0.f;
  }
  gmt_cp_async_wait<0>();
  __syncthreads();

  unsigned qa[P::KD][4], doa[P::KD][4];
  ft_a_frags<P::KD, LD>(qa, qs, 16 * warp);
  ft_a_frags<P::KD, LD>(doa, dos, 16 * warp);
  const float dl[2] = {dls[16 * warp + g], dls[16 * warp + g + 8]};
  const float sl2 = scale * BWD_LOG2E;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      gmt_cp_async_wait<0>();
      // tile t has landed for every thread, and every warp is past tile
      // t - 1, whose stage the next copies refill
      __syncthreads();
    }
    if (t + 1 < n_tiles) {
      __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
      ft_load_tile<BKV, DP, BWD_THREADS>(st, kb, (t + 1) * BKV, T, D);
      ft_load_tile<BKV, DP, BWD_THREADS>(st + TILE, vb, (t + 1) * BKV, T, D);
      gmt_cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (t % 2) * 2 * TILE;
    if ((t + 1) * BKV - 1 > q0)  // some key here lies past the block's first row
      ft_dq_tile<DP, BKV, true>(acc, qa, doa, ks, ks + TILE, t * BKV, wr0, 0, T, sl2, lg, dl);
    else
      ft_dq_tile<DP, BKV, false>(acc, qa, doa, ks, ks + TILE, t * BKV, wr0, 0, T, sl2, lg, dl);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    if (row >= T) continue;
    float* dst = dq + base + (size_t)row * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, BwdPlan<DP>::MINB_D) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int T, int D, float scale) {
  using P = BwdPlan<DP>;
  constexpr int KD = P::KD, LD = P::LD, BQ = P::SROWS, TILE = P::STILE;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + BWD_ROWS * LD;
  __nv_bfloat16* ring = vs + BWD_ROWS * LD;  // stage s: Q at ring + 2 s TILE, dO after it
  float* rows = reinterpret_cast<float*>(ring + 4 * TILE);  // stage s: lse at rows + 2 s BQ, delta after
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BWD_ROWS;  // the first key tiles see the most queries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wk0 = k0 + 16 * warp;  // the warp's first key
  const size_t base = (size_t)bh * T * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* dob = dout + base;
  const float* lb = lse + (size_t)bh * T;
  const float* db = delta + (size_t)bh * T;
  const int n_tiles = (T - k0 + BQ - 1) / BQ;  // queries before k0 see none of these keys

  ft_load_tile<BWD_ROWS, DP, BWD_THREADS>(ks, k + base, k0, T, D);
  ft_load_tile<BWD_ROWS, DP, BWD_THREADS>(vs, v + base, k0, T, D);
  ft_load_tile<BQ, DP, BWD_THREADS>(ring, qb, k0, T, D);
  ft_load_tile<BQ, DP, BWD_THREADS>(ring + TILE, dob, k0, T, D);
  ft_load_row<BQ, BWD_THREADS>(rows, lb, k0, T);
  ft_load_row<BQ, BWD_THREADS>(rows + BQ, db, k0, T);
  gmt_cp_async_commit();
  gmt_cp_async_wait<0>();
  __syncthreads();

  unsigned ka[KD][4], va[KD][4];  // at DP > 64 re-read each chunk (registers)
  if constexpr (DP <= 64) {
    ft_a_frags<KD, LD>(ka, ks, 16 * warp);
    ft_a_frags<KD, LD>(va, vs, 16 * warp);
  }
  const float sl2 = scale * BWD_LOG2E;
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      gmt_cp_async_wait<0>();
      __syncthreads();  // as in E
    }
    if (t + 1 < n_tiles) {
      const int nq0 = k0 + (t + 1) * BQ;
      __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
      float* sr = rows + ((t + 1) % 2) * 2 * BQ;
      ft_load_tile<BQ, DP, BWD_THREADS>(st, qb, nq0, T, D);
      ft_load_tile<BQ, DP, BWD_THREADS>(st + TILE, dob, nq0, T, D);
      ft_load_row<BQ, BWD_THREADS>(sr, lb, nq0, T);
      ft_load_row<BQ, BWD_THREADS>(sr + BQ, db, nq0, T);
      gmt_cp_async_commit();
    }
    const int q0 = k0 + t * BQ;
    const __nv_bfloat16* qs = ring + (t % 2) * 2 * TILE;
    const float* ls = rows + (t % 2) * 2 * BQ;
    // some query here precedes the block's last key, or lies past T
    if (q0 < k0 + BWD_ROWS - 1 || q0 + BQ > T)
      ft_dkv_tile<DP, BQ, true>(dka, dva, ka, va, ks, vs, qs, qs + TILE, ls, ls + BQ, q0, wk0,
                                16 * warp, 0, T, sl2);
    else
      ft_dkv_tile<DP, BQ, false>(dka, dva, ka, va, ks, vs, qs, qs + TILE, ls, ls + BQ, q0, wk0,
                                 16 * warp, 0, T, sl2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = wk0 + g + 8 * h;
    if (key >= T) continue;
    float* dkr = dk + base + (size_t)key * D + c;
    float* dvr = dv + base + (size_t)key * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D) {
        *reinterpret_cast<float2*>(dkr + 8 * n) =
            make_float2(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dvr + 8 * n) = make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
      }
  }
}

template <int DP>
int launch_dq(int BH, cudaStream_t stream, const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const float* o, const __nv_bfloat16* dout, const float* lse,
              float* delta, float* dq, int T, int D, float scale) {
  constexpr size_t smem = BwdPlan<DP>::DQ_SMEM;
  const cudaError_t e = gmt_allow_smem(flash_bwd_dq_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BWD_ROWS - 1) / BWD_ROWS, BH);
  flash_bwd_dq_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(q, k, v, o, dout, lse, delta, dq,
                                                               T, D, scale);
  return cudaGetLastError();
}

template <int DP>
int launch_dkv(int BH, cudaStream_t stream, const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
               const float* delta, float* dk, float* dv, int T, int D, float scale) {
  constexpr size_t smem = BwdPlan<DP>::DKV_SMEM;
  const cudaError_t e = gmt_allow_smem(flash_bwd_dkv_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BWD_ROWS - 1) / BWD_ROWS, BH);
  flash_bwd_dkv_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                                                dv, T, D, scale);
  return cudaGetLastError();
}

// E: dq (BH, T, D) and delta (BH, T), both f32. Launch before D. D is padded
// to the smallest bucket >= D.
extern "C" int gmt_flash_bwd_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const float* o,
                                const __nv_bfloat16* dout, const float* lse,
                                float* delta, float* dq, int BH, int T, int D,
                                float scale, cudaStream_t stream) {
  auto go = D <= 16 ? launch_dq<16> : D <= 32 ? launch_dq<32> : D <= 64 ? launch_dq<64>
                                                                         : launch_dq<128>;
  return go(BH, stream, q, k, v, o, dout, lse, delta, dq, T, D, scale);
}

// D: dk, dv (BH, T, D) f32, from the delta that E wrote.
extern "C" int gmt_flash_bwd_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                 const float* lse, const float* delta, float* dk,
                                 float* dv, int BH, int T, int D, float scale,
                                 cudaStream_t stream) {
  auto go = D <= 16 ? launch_dkv<16> : D <= 32 ? launch_dkv<32> : D <= 64 ? launch_dkv<64>
                                                                           : launch_dkv<128>;
  return go(BH, stream, q, k, v, dout, lse, delta, dk, dv, T, D, scale);
}
