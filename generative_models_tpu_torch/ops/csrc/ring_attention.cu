// Kernels K, L and M: one hop of ring attention, for sm_90a.
//
// Replaces: generative_models_tpu/ops/attention.py _ring_chunk_fwd_kernel
// (:565, called by _ring_chunk_fwd :609) with Kernel K (the hop forward),
// and _ring_chunk_bwd_kernel (:675, called by _ring_chunk_bwd :733) with
// Kernel L (the hop's dQ) and Kernel M (the hop's dK and dV).
// parallel/ring_attention.py runs the hops.
//
// A ring of n positions splits the sequence into n chunks of t_valid
// tokens, each padded to Tp rows in memory. At hop h ring position p folds
// in chunk c = (p - h) mod n: the causal mask is taken on global positions,
// q_start + row >= k_start + col with q_start = p * t_valid and k_start =
// c * t_valid, and keys at or past t_valid are masked. One launch runs one
// hop for the P positions it is given: with P == n every position lies on
// this card and reads chunk c where it lies (the rotation is an index, so
// no K/V copy moves through device memory at a hop); with P < n (one rank
// of a process group) slot j of k and v holds the chunk that arrived for
// position pos0 + j.
//
//   K: (acc, m, l) += the online softmax of q against the visiting chunk,
//      from the carry (acc_in, m_in, l_in) or, when those are null (the
//      first hop, the init variant), from acc = 0, m = -1e30, l = 0. acc is
//      unnormalised and m is in natural units, as the plain version, L, M
//      and ring_forward's m + log(l) read them.
//   L: dq = dq_in + dS k * scale, dS = P * (dO v^T - delta), P = exp(q k^T
//      * scale - lse); dq_in null means 0.
//   M: dk = dk_in + dS^T q * scale and dv = dv_in + P^T dO onto the
//      visiting chunk's accumulators (slot c, or slot j across ranks).
// q, k, v, dO are bf16; every sum is f32.
//
// The TPU kernel seeded dK/dV in VMEM at the first q block and added to
// them across the sequential q-block grid axis (:687-694, :719-720). Blocks
// on Hopper run in no order, so the backward is split as Kernels E and D
// split the flash backward: L owns query rows, M owns key rows; no atomics,
// every sum in a fixed order, so two launches on the same inputs give
// bitwise the same outputs.
//
// The three are the hop forms of Kernels C (K), E (L) and D (M), on the
// tensor cores through flash_tiles.cuh, whose tile routines they share with
// those kernels (ft_fwd_tile, ft_dq_tile, ft_dkv_tile), with diag = q_start
// - k_start in place of the flat kernels' 0 and t_valid in place of T:
//   * one block of four warps per (ring position, bh, 64-row tile): query
//     rows for K and L (q, and dO for L, as mma A fragments, 16 rows a
//     warp), key rows for M (k and v as A fragments);
//   * the other side streams by 16-byte cp.async into a double-buffered
//     ring, one barrier a tile: K/V tiles of 64 keys (32 at D > 64, where
//     the accumulators take the registers) for K and L, up to the block's
//     live bound; Q/dO tiles with their lse and delta for M, from the first
//     query that sees a key of the block to t_valid;
//   * P (K, M) and dS (L, M) enter their products split into bf16 parts
//     (P = 2^(S scale log2 e - m) or 2^(S scale log2 e - lse log2 e)):
//     rounded once they move the outputs past the port's contract
//     (attention.cu, attention_bwd.cu; the TPU kernel rounds them, :308 and
//     :717-721; the plain versions in ops/attention.py keep them f32). L and
//     M take hi/lo pairs, as E and D do. K takes three parts (hi, mid, lo:
//     one more product a chunk): its acc is an unnormalised sum, held
//     element by element to atol 2e-5 + rtol 2e-4, and a pair's error
//     (~2^-18 of each P, up to 4.7e-5 on an acc at the seq:4 shape) misses
//     that where |acc| is small, which C's o, divided by l, never shows;
//   * only a tile that crosses the global diagonal or t_valid takes the
//     masks: on one card a carry hop's live position sees its whole chunk,
//     so there only the t_valid tile does;
//   * K works in log2 units: m_in scale log2 e at entry, m ln 2 at exit,
//     the sentinel -1e30 in both (finite, so m - m_new is never NaN). acc
//     and l are read from the carry before the first tile lands (l_in into
//     one lane of the quad whose partial sums meet at the end), acc in the
//     mma C-fragment layout, 8 bytes a thread;
//   * D is padded to 16, 32, 64 or 128; D must be a multiple of 8 up to
//     128 (the C entries refuse anything else), q, k, v and dO 16-byte
//     aligned and the f32 carries 8-byte aligned (the wrappers copy).
//
// Bounds. A query tile of K or L stops at the last key that any of its rows
// can see (the TPU kernel's _live_kv_bound, :550, taken per element), so a
// chunk wholly in a tile's future costs nothing; M starts at the first
// query that can see any key of its tile (the transpose of that bound).
// The ring's first hop is the diagonal chunk, so every row meets a live key
// in its first tile and m is finite from then on: a tile in which a row
// sees no key then adds 2^(-1e30 - m) = 0. That is why the sentinel is a
// finite -1e30 and why the diagonal comes first.
//
// Padded rows. K computes query rows at or past t_valid as the plain
// version does, from q as it lies in memory (the caller slices them off;
// were they to keep the carry, ring_forward would give them lse ~ -1e30,
// and the plain backward exp(+1e30) * 0 = NaN). L and M load them as
// zeros: the caller's dO is zero there, so they add exactly 0, and L's rows
// keep dq_in. Keys at or past t_valid load as zeros; K and L mask them, and
// M drops their rows' sums (their P would be 2^(-lse), not 0): they keep
// dk_in and dv_in. A block with nothing to add returns at once where the
// carry is updated in place, and writes the carry through (or the first
// hop's seed) otherwise.
//
// What bounds it on an H100: at the pixel_transformer training shape (BH =
// 256, D = 32, T = 784) on a ring of 4 (t_valid = 196, Tp = 256) one hop of
// K moves ~121 MB (q, k, v bf16, the f32 carry read and written; ~36 us at
// 3.35 TB/s) against ~4 GFLOP over the hop's live pairs (~4 us at the bf16
// tensor-core peak): bound by bytes, the carry's f32 traffic the largest
// part. L and M move ~103 MB and ~137 MB a hop. mma.sync does not reach the
// tensor-core peak (wgmma does), and each 16-row chunk of a warp is one
// dependent chain, so in practice the chain's latency and the products'
// issue rate set the pace, as for C, E and D (PERF.md section 6). The first
// designs (one thread a row, f32 K/V or Q/dO tiles and FMA on the CUDA
// cores, every padded row computed) took 0.4500 (K), 0.6640 (L) and 0.6938
// (M) ms a seq:4 carry hop on an NVIDIA H100 80GB HBM3 at 700 W.

#include "common.cuh"
#include "flash_tiles.cuh"

constexpr int RING_ROWS = 64;      // query (K, L) or key (M) rows a block, 16 a warp
constexpr int RING_THREADS = 128;  // four warps
constexpr float RING_LOG2E = 1.4426950408889634f;
constexpr float RING_LN2 = 0.6931471805599453f;

// Each kernel's streamed-tile depth and register cap (blocks an SM) at DP =
// 32, every path's width (ops/knob_sweep.py rewrites these lines, and its
// sweep chose them): K 5 blocks an SM (96 registers; at C's 4, 122
// registers, its first hop ran 1.8-2.7 % slower in three sweeps, its carry
// hop within 1 %), L E's 6, M 4 (at D's 5, 96 registers, it spills). A
// block's chunks run as one dependent chain, and more warps to switch
// between hide it better than more registers help one warp.
constexpr int K_SROWS_D32 = 64, K_MINB_D32 = 5;
constexpr int L_SROWS_D32 = 64, L_MINB_D32 = 6;
constexpr int M_SROWS_D32 = 64, M_MINB_D32 = 4;

// One hop kernel's tiling of one D bucket: streamed tiles of SROWS rows,
// 32 at DP = 128 where the accumulators take the registers, and MINB
// blocks an SM at DP = 32 (the other buckets take what ptxas gives them).
template <int DP, int SROWS_D32, int MINB_D32>
struct HopPlan {
  static constexpr int SROWS = DP > 64 ? 32 : DP == 32 ? SROWS_D32 : 64;
  static constexpr int MINB = DP == 32 ? MINB_D32 : 1;
  static constexpr int LD = DP + 8, KD = DP / 16, STILE = SROWS * LD;
  // OWN tiles of the block's own rows, then two stages of two streamed
  // tiles, then (M) two stages of two f32 rows (lse, delta)
  static constexpr size_t smem(int own, bool rows) {
    return (size_t)(own * RING_ROWS * LD + 4 * STILE) * 2 + (rows ? 4 * SROWS * 4 : 0);
  }
};
template <int DP>
using FwdHopPlan = HopPlan<DP, K_SROWS_D32, K_MINB_D32>;
template <int DP>
using DqHopPlan = HopPlan<DP, L_SROWS_D32, L_MINB_D32>;
template <int DP>
using DkvHopPlan = HopPlan<DP, M_SROWS_D32, M_MINB_D32>;

// Where slot j of a launch finds its data at hop `hop`.
struct HopItem {
  int q_start, k_start;  // global positions of the query chunk and the visiting chunk
  size_t q_off, kv_off, row_off;  // element offsets of (j, bh) in q, k and the rows
};

__device__ __forceinline__ HopItem hop_item(int j, int bh, int P, int BH, int Tp, int D,
                                            int t_valid, int pos0, int n_ring, int hop) {
  const int p = pos0 + j;
  const int c = ((p - hop) % n_ring + n_ring) % n_ring;
  const int kv = P == n_ring ? c : j;
  HopItem it;
  it.q_start = p * t_valid;
  it.k_start = c * t_valid;
  it.q_off = ((size_t)j * BH + bh) * Tp * D;
  it.kv_off = ((size_t)kv * BH + bh) * Tp * D;
  it.row_off = ((size_t)j * BH + bh) * Tp;
  return it;
}

// Number of the chunk's keys that some row of the query tile [q0, last] can
// see: the live bound, per element.
__device__ __forceinline__ int live_keys(const HopItem& it, int last, int t_valid) {
  return max(0, min(t_valid, it.q_start + last - it.k_start + 1));
}

// ---------------------------------------------------------------- Kernel K

// Kernel K. acc_in/m_in/l_in may alias acc_out/m_out/l_out (the carry
// updated in place): each thread reads its own elements of acc before it
// writes them, and a row's m and l are written by one lane of its quad after
// the quad's shuffles, which every lane reaches past its reads.
template <int DP>
__global__ void __launch_bounds__(RING_THREADS, FwdHopPlan<DP>::MINB) ring_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* acc_in, const float* m_in,
    const float* l_in, float* acc_out, float* m_out, float* l_out, int P, int BH, int Tp,
    int D, int t_valid, int pos0, int n_ring, int hop, float scale) {
  using PL = FwdHopPlan<DP>;
  constexpr int LD = PL::LD, KD = PL::KD, BKV = PL::SROWS, TILE = PL::STILE;
  extern __shared__ __align__(16) unsigned char rk_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(rk_smem);
  __nv_bfloat16* ring = qs + RING_ROWS * LD;  // stage s: K at ring + 2 s TILE, V after it
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RING_ROWS;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const int diag = it.q_start - it.k_start;
  // keys that some row of the tile sees, rows past t_valid included
  const int kv_end = live_keys(it, min(q0 + RING_ROWS, Tp) - 1, t_valid);
  if (kv_end == 0 && acc_in == acc_out) return;  // the carry stays as it is
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const __nv_bfloat16* kb = k + it.kv_off;
  const __nv_bfloat16* vb = v + it.kv_off;
  if (n_tiles > 0) {
    // q rows as they lie in memory up to Tp; keys at or past t_valid as zeros
    ft_load_tile<RING_ROWS, DP, RING_THREADS>(qs, q + it.q_off, q0, Tp, D);
    ft_load_tile<BKV, DP, RING_THREADS>(ring, kb, 0, t_valid, D);
    ft_load_tile<BKV, DP, RING_THREADS>(ring + TILE, vb, 0, t_valid, D);
    gmt_cp_async_commit();
  }

  // while the copies fly: the carry of this thread's rows g and g + 8
  float acc[DP / 8][4], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    const bool in = acc_in != nullptr && row < Tp;
    m[h] = in ? m_in[it.row_off + row] * RING_LOG2E : GMT_NEG_INF;
    l[h] = in && c == 0 ? l_in[it.row_off + row] : 0.f;
    const size_t off = it.q_off + (size_t)row * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const float2 a = in && 8 * n < D ? *reinterpret_cast<const float2*>(acc_in + off + 8 * n)
                                       : make_float2(0.f, 0.f);
      acc[n][2 * h] = a.x;
      acc[n][2 * h + 1] = a.y;
    }
  }

  if (n_tiles > 0) {
    gmt_cp_async_wait<0>();
    __syncthreads();
    unsigned qa[KD][4];
    ft_a_frags<KD, LD>(qa, qs, 16 * warp);
    const float sl2 = scale * RING_LOG2E;
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) {
        gmt_cp_async_wait<0>();
        // tile t has landed for every thread, and every warp is past tile
        // t - 1, whose stage the next copies refill
        __syncthreads();
      }
      if (t + 1 < n_tiles) {
        __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
        ft_load_tile<BKV, DP, RING_THREADS>(st, kb, (t + 1) * BKV, t_valid, D);
        ft_load_tile<BKV, DP, RING_THREADS>(st + TILE, vb, (t + 1) * BKV, t_valid, D);
        gmt_cp_async_commit();
      }
      const __nv_bfloat16* ks = ring + (t % 2) * 2 * TILE;
      const int k0 = t * BKV;
      if (k0 + BKV - 1 > diag + q0 || k0 + BKV > t_valid)
        ft_fwd_tile<DP, BKV, true, true>(acc, m, l, qa, ks, ks + TILE, k0, wr0, diag, t_valid,
                                        sl2);
      else
        ft_fwd_tile<DP, BKV, false, true>(acc, m, l, qa, ks, ks + TILE, k0, wr0, diag, t_valid,
                                         sl2);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = wr0 + g + 8 * h;
    if (row >= Tp) continue;
    const size_t off = it.q_off + (size_t)row * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(acc_out + off + 8 * n) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    if (c == 0) {
      m_out[it.row_off + row] = m[h] * RING_LN2;
      l_out[it.row_off + row] = l[h];
    }
  }
}

// ---------------------------------------------------------------- Kernel L

// Kernel L. dq_in may alias dq_out (in place): each thread reads its own
// elements before it writes them.
template <int DP>
__global__ void __launch_bounds__(RING_THREADS, DqHopPlan<DP>::MINB) ring_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* dq_in,
    float* dq_out, int P, int BH, int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
    float scale) {
  using PL = DqHopPlan<DP>;
  constexpr int LD = PL::LD, KD = PL::KD, BKV = PL::SROWS, TILE = PL::STILE;
  extern __shared__ __align__(16) unsigned char rl_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(rl_smem);
  __nv_bfloat16* dos = qs + RING_ROWS * LD;
  __nv_bfloat16* ring = dos + RING_ROWS * LD;  // stage s: K at ring + 2 s TILE, V after it
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RING_ROWS;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const int diag = it.q_start - it.k_start;
  // keys that a row of the tile below t_valid sees
  const int kv_end = q0 < t_valid ? live_keys(it, min(q0 + RING_ROWS, t_valid) - 1, t_valid) : 0;
  if (kv_end == 0 && dq_in == dq_out) return;  // nothing to add to dq in place
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (n_tiles > 0) {
    const __nv_bfloat16* kb = k + it.kv_off;
    const __nv_bfloat16* vb = v + it.kv_off;
    // rows and keys at or past t_valid load as zeros
    ft_load_tile<RING_ROWS, DP, RING_THREADS>(qs, q + it.q_off, q0, t_valid, D);
    ft_load_tile<RING_ROWS, DP, RING_THREADS>(dos, dout + it.q_off, q0, t_valid, D);
    ft_load_tile<BKV, DP, RING_THREADS>(ring, kb, 0, t_valid, D);
    ft_load_tile<BKV, DP, RING_THREADS>(ring + TILE, vb, 0, t_valid, D);
    gmt_cp_async_commit();
    // lse * log2(e) and delta of this thread's rows g and g + 8 (0 from t_valid)
    float lg[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr0 + g + 8 * h;
      lg[h] = row < t_valid ? lse[it.row_off + row] * RING_LOG2E : 0.f;
      dl[h] = row < t_valid ? delta[it.row_off + row] : 0.f;
    }
    gmt_cp_async_wait<0>();
    __syncthreads();

    unsigned qa[KD][4], doa[KD][4];
    ft_a_frags<KD, LD>(qa, qs, 16 * warp);
    ft_a_frags<KD, LD>(doa, dos, 16 * warp);
    const float sl2 = scale * RING_LOG2E;
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) {
        gmt_cp_async_wait<0>();
        // tile t has landed for every thread, and every warp is past tile
        // t - 1, whose stage the next copies refill
        __syncthreads();
      }
      if (t + 1 < n_tiles) {
        __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
        ft_load_tile<BKV, DP, RING_THREADS>(st, kb, (t + 1) * BKV, t_valid, D);
        ft_load_tile<BKV, DP, RING_THREADS>(st + TILE, vb, (t + 1) * BKV, t_valid, D);
        gmt_cp_async_commit();
      }
      if (wr0 >= t_valid) continue;  // the warp's rows keep dq_in
      const __nv_bfloat16* ks = ring + (t % 2) * 2 * TILE;
      const int k0 = t * BKV;
      if (k0 + BKV - 1 > diag + q0 || k0 + BKV > t_valid)
        ft_dq_tile<DP, BKV, true>(acc, qa, doa, ks, ks + TILE, k0, wr0, diag, t_valid, sl2, lg,
                                  dl);
      else
        ft_dq_tile<DP, BKV, false>(acc, qa, doa, ks, ks + TILE, k0, wr0, diag, t_valid, sl2, lg,
                                   dl);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    if (row >= Tp) continue;
    const size_t off = it.q_off + (size_t)row * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D) {
        const float2 in = dq_in ? *reinterpret_cast<const float2*>(dq_in + off + 8 * n)
                                : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dq_out + off + 8 * n) =
            make_float2(in.x + acc[n][2 * h] * scale, in.y + acc[n][2 * h + 1] * scale);
      }
  }
}

// ---------------------------------------------------------------- Kernel M

// Kernel M. dk_in/dv_in may alias dk_out/dv_out: each thread reads its own
// elements before it writes them.
template <int DP>
__global__ void __launch_bounds__(RING_THREADS, DkvHopPlan<DP>::MINB) ring_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* dk_in,
    const float* dv_in, float* dk_out, float* dv_out, int P, int BH, int Tp, int D,
    int t_valid, int pos0, int n_ring, int hop, float scale) {
  using PL = DkvHopPlan<DP>;
  constexpr int LD = PL::LD, KD = PL::KD, BQ = PL::SROWS, TILE = PL::STILE;
  extern __shared__ __align__(16) unsigned char rm_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(rm_smem);
  __nv_bfloat16* vs = ks + RING_ROWS * LD;
  __nv_bfloat16* ring = vs + RING_ROWS * LD;  // stage s: Q at ring + 2 s TILE, dO after it
  // stage s: lse at rows + 2 s BQ, delta after it
  float* rows = reinterpret_cast<float*>(ring + 4 * TILE);
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int kt0 = blockIdx.x * RING_ROWS;  // the first key tiles see the most queries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wk0 = kt0 + 16 * warp;  // the warp's first key
  const int diag = it.q_start - it.k_start;
  // the queries that see a key of the tile: from the first that sees key
  // kt0 (the transpose of the live bound) up to t_valid, past which rows
  // add exactly 0; a tile wholly past t_valid sees none
  const int q_lo = max(0, kt0 - diag);
  const int q_hi = kt0 < t_valid ? t_valid : 0;
  const int n_tiles = q_lo < q_hi ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  if (n_tiles == 0 && dk_in == dk_out) return;  // nothing to add to dk, dv in place

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  if (n_tiles > 0) {
    const __nv_bfloat16* qb = q + it.q_off;
    const __nv_bfloat16* dob = dout + it.q_off;
    const float* lb = lse + it.row_off;
    const float* db = delta + it.row_off;
    // keys and queries at or past t_valid load as zeros, their lse and
    // delta as 0
    ft_load_tile<RING_ROWS, DP, RING_THREADS>(ks, k + it.kv_off, kt0, t_valid, D);
    ft_load_tile<RING_ROWS, DP, RING_THREADS>(vs, v + it.kv_off, kt0, t_valid, D);
    ft_load_tile<BQ, DP, RING_THREADS>(ring, qb, q_lo, t_valid, D);
    ft_load_tile<BQ, DP, RING_THREADS>(ring + TILE, dob, q_lo, t_valid, D);
    ft_load_row<BQ, RING_THREADS>(rows, lb, q_lo, t_valid);
    ft_load_row<BQ, RING_THREADS>(rows + BQ, db, q_lo, t_valid);
    gmt_cp_async_commit();
    gmt_cp_async_wait<0>();
    __syncthreads();

    unsigned ka[KD][4], va[KD][4];  // at DP > 64 re-read each chunk (registers)
    if constexpr (DP <= 64) {
      ft_a_frags<KD, LD>(ka, ks, 16 * warp);
      ft_a_frags<KD, LD>(va, vs, 16 * warp);
    }
    const float sl2 = scale * RING_LOG2E;
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) {
        gmt_cp_async_wait<0>();
        __syncthreads();  // as in K
      }
      if (t + 1 < n_tiles) {
        const int nq0 = q_lo + (t + 1) * BQ;
        __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
        float* sr = rows + ((t + 1) % 2) * 2 * BQ;
        ft_load_tile<BQ, DP, RING_THREADS>(st, qb, nq0, t_valid, D);
        ft_load_tile<BQ, DP, RING_THREADS>(st + TILE, dob, nq0, t_valid, D);
        ft_load_row<BQ, RING_THREADS>(sr, lb, nq0, t_valid);
        ft_load_row<BQ, RING_THREADS>(sr + BQ, db, nq0, t_valid);
        gmt_cp_async_commit();
      }
      if (wk0 >= t_valid) continue;  // the warp's keys keep dk_in, dv_in
      const int q0 = q_lo + t * BQ;
      const __nv_bfloat16* qs = ring + (t % 2) * 2 * TILE;
      const float* ls = rows + (t % 2) * 2 * BQ;
      // a query row past t_valid has q = dO = 0 and lse = delta = 0: P = 1
      // and dS = 0 there, so it adds exactly 0 to dV and dK. Some query
      // here precedes the block's last key, or lies past t_valid:
      if (q0 + diag < kt0 + RING_ROWS - 1 || q0 + BQ > t_valid)
        ft_dkv_tile<DP, BQ, true>(dka, dva, ka, va, ks, vs, qs, qs + TILE, ls, ls + BQ, q0, wk0,
                                  16 * warp, diag, t_valid, sl2);
      else
        ft_dkv_tile<DP, BQ, false>(dka, dva, ka, va, ks, vs, qs, qs + TILE, ls, ls + BQ, q0,
                                   wk0, 16 * warp, diag, t_valid, sl2);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = wk0 + g + 8 * h;
    if (key >= Tp) continue;
    const bool live = key < t_valid;  // a key past t_valid keeps dk_in, dv_in
    const size_t off = it.kv_off + (size_t)key * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D) {
        const float2 ki = dk_in ? *reinterpret_cast<const float2*>(dk_in + off + 8 * n)
                                : make_float2(0.f, 0.f);
        const float2 vi = dv_in ? *reinterpret_cast<const float2*>(dv_in + off + 8 * n)
                                : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dk_out + off + 8 * n) =
            live ? make_float2(ki.x + dka[n][2 * h] * scale, ki.y + dka[n][2 * h + 1] * scale)
                 : ki;
        *reinterpret_cast<float2*>(dv_out + off + 8 * n) =
            live ? make_float2(vi.x + dva[n][2 * h], vi.y + dva[n][2 * h + 1]) : vi;
      }
  }
}

template <int DP>
static int launch_ring_fwd(dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                           const __nv_bfloat16* k, const __nv_bfloat16* v, const float* acc_in,
                           const float* m_in, const float* l_in, float* acc, float* m, float* l,
                           int P, int BH, int Tp, int D, int t_valid, int pos0, int n_ring,
                           int hop, float scale) {
  constexpr size_t smem = FwdHopPlan<DP>::smem(1, false);
  const cudaError_t e = gmt_allow_smem(ring_fwd_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  ring_fwd_kernel<DP><<<grid, RING_THREADS, smem, stream>>>(
      q, k, v, acc_in, m_in, l_in, acc, m, l, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
}

template <int DP>
static int launch_ring_dq(dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                          const __nv_bfloat16* k, const __nv_bfloat16* v,
                          const __nv_bfloat16* dout, const float* lse, const float* delta,
                          const float* dq_in, float* dq, int P, int BH, int Tp, int D,
                          int t_valid, int pos0, int n_ring, int hop, float scale) {
  constexpr size_t smem = DqHopPlan<DP>::smem(2, false);
  const cudaError_t e = gmt_allow_smem(ring_bwd_dq_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  ring_bwd_dq_kernel<DP><<<grid, RING_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_in, dq, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
}

template <int DP>
static int launch_ring_dkv(dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                           const __nv_bfloat16* k, const __nv_bfloat16* v,
                           const __nv_bfloat16* dout, const float* lse, const float* delta,
                           const float* dk_in, const float* dv_in, float* dk, float* dv, int P,
                           int BH, int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
                           float scale) {
  constexpr size_t smem = DkvHopPlan<DP>::smem(2, true);
  const cudaError_t e = gmt_allow_smem(ring_bwd_dkv_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  ring_bwd_dkv_kernel<DP><<<grid, RING_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk_in, dv_in, dk, dv, P, BH, Tp, D, t_valid, pos0, n_ring, hop,
      scale);
  return cudaGetLastError();
}

// The C entries. Each refuses a D that is not a multiple of 8 in [8, 128]
// and pads D to the smallest bucket >= D. q, k, v and dout 16-byte
// aligned, the f32 carries 8-byte aligned.

// K: one hop for P ring positions; acc (P, BH, Tp, D), m, l (P, BH, Tp) f32.
// acc_in, m_in, l_in null: the first hop.
extern "C" int gmt_ring_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, const float* acc_in, const float* m_in,
                            const float* l_in, float* acc, float* m, float* l, int P, int BH,
                            int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
                            float scale, cudaStream_t stream) {
  if (D % 8 || D < 8 || D > 128) return cudaErrorInvalidValue;
  const dim3 grid((Tp + RING_ROWS - 1) / RING_ROWS, BH, P);
  auto go = D <= 16 ? launch_ring_fwd<16> : D <= 32 ? launch_ring_fwd<32>
                                         : D <= 64 ? launch_ring_fwd<64> : launch_ring_fwd<128>;
  return go(grid, stream, q, k, v, acc_in, m_in, l_in, acc, m, l, P, BH, Tp, D, t_valid, pos0,
            n_ring, hop, scale);
}

// L: dq (P, BH, Tp, D) f32; dq_in null: the first hop.
extern "C" int gmt_ring_bwd_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const __nv_bfloat16* dout,
                               const float* lse, const float* delta, const float* dq_in,
                               float* dq, int P, int BH, int Tp, int D, int t_valid, int pos0,
                               int n_ring, int hop, float scale, cudaStream_t stream) {
  if (D % 8 || D < 8 || D > 128) return cudaErrorInvalidValue;
  const dim3 grid((Tp + RING_ROWS - 1) / RING_ROWS, BH, P);
  auto go = D <= 16 ? launch_ring_dq<16> : D <= 32 ? launch_ring_dq<32>
                                        : D <= 64 ? launch_ring_dq<64> : launch_ring_dq<128>;
  return go(grid, stream, q, k, v, dout, lse, delta, dq_in, dq, P, BH, Tp, D, t_valid, pos0,
            n_ring, hop, scale);
}

// M: dk, dv with k's slots, f32; dk_in, dv_in null: the first hop.
extern "C" int gmt_ring_bwd_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                const float* lse, const float* delta, const float* dk_in,
                                const float* dv_in, float* dk, float* dv, int P, int BH, int Tp,
                                int D, int t_valid, int pos0, int n_ring, int hop, float scale,
                                cudaStream_t stream) {
  if (D % 8 || D < 8 || D > 128) return cudaErrorInvalidValue;
  const dim3 grid((Tp + RING_ROWS - 1) / RING_ROWS, BH, P);
  auto go = D <= 16 ? launch_ring_dkv<16> : D <= 32 ? launch_ring_dkv<32>
                                         : D <= 64 ? launch_ring_dkv<64> : launch_ring_dkv<128>;
  return go(grid, stream, q, k, v, dout, lse, delta, dk_in, dv_in, dk, dv, P, BH, Tp, D, t_valid,
            pos0, n_ring, hop, scale);
}
