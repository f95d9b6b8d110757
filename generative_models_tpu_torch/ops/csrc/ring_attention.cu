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
//      first hop, the init variant), from acc = 0, m = -1e30, l = 0.
//   L: dq = dq_in + dS k * scale, dS = P * (dO v^T - delta), P = exp(q k^T
//      * scale - lse); dq_in null means 0.
//   M: dk = dk_in + dS^T q * scale and dv = dv_in + P^T dO onto the
//      visiting chunk's accumulators (slot c, or slot j across ranks).
// q, k, v, dO are bf16; every sum is f32. K and M keep P and dS in f32;
// L carries dS as a bf16 hi/lo pair into its tensor-core product, as
// Kernels D and E do (attention_bwd.cu: rounded once it misses the port's
// contract). (The TPU kernel rounds P and dS to bf16 before its products,
// :308 and :717-721; the plain versions in ops/attention.py keep them f32.)
//
// The TPU kernel seeded dK/dV in VMEM at the first q block and added to
// them across the sequential q-block grid axis (:687-694, :719-720). Blocks
// on Hopper run in no order, so the backward is split as Kernels E and D
// split the flash backward: L owns query rows, M owns key rows; no atomics,
// every sum in a fixed order.
//
// Bounds. A query tile of K or L stops at the last key that any of its rows
// can see (the TPU kernel's _live_kv_bound, :550, taken per element), so a
// chunk wholly in a tile's future costs nothing; M starts at the first
// query that can see any key of its tile (the transpose of that bound).
// The ring's first hop is the diagonal chunk, so every row meets a live key
// in its first tile and m is finite from then on: a tile in which a row
// sees no key then adds exp(-1e30 - m) = 0. That is why the sentinel is a
// finite -1e30 and why the diagonal comes first.
//
// Padded rows. Query rows at or past t_valid compute junk that the caller
// slices off; their dO is zero (the caller pads it so), which makes their
// dK/dV terms exactly 0, so M stops at t_valid.
//
// What bounds it on an H100: at the pixel_transformer training shape (BH =
// 256, D = 32, T = 784) on a ring of 4 (t_valid = 196, Tp = 256) one hop of
// K moves ~121 MB (q, k, v bf16, the f32 carry read and written; ~36 us at
// 3.35 TB/s) against ~4 GFLOP over the hop's live pairs (~4 us at the bf16
// tensor-core peak): bound by bytes, the carry's f32 traffic the largest
// part. L and M move ~103 MB and ~137 MB a hop.
//
// K and M (first designs) follow Kernel C's first design: one block per
// (ring position, bh, 64-row tile), one thread per query row (per key row
// in M), q, dO and the accumulators in registers, K/V (Q/dO in M) tiles of
// 32 staged in shared memory as f32, D padded in registers to a bucket (8,
// 16, 32, 64, 128), plain FMA on f32; on FMA units the products bound
// them, each score a D-long chain of a shared-memory read and an FMA per
// element. PERF.md records their times against the bound.
//
// L is Kernel E's hop form, on the tensor cores through flash_tiles.cuh:
// one block of four warps per (ring position, bh, 64-row query tile), each
// warp 16 query rows with q and dO as mma A fragments; K/V tiles of 64 keys
// (32 at D > 64) by 16-byte cp.async, double-buffered, one barrier a tile,
// up to the tile's live bound; S and dP by ft_scores, P = 2^(S scale log2 e
// - lse log2 e), dS split by ft_split and dq += dS k by ft_accum (four
// products a 16-key chunk). Only a tile that crosses the global diagonal or
// t_valid takes the mask (at a hop >= 1 on one card a live position sees
// its whole chunk, so only the t_valid tile). Rows at or past t_valid
// keep dq_in (their dO and delta are 0, so is their dS): they load as
// zeros, and a warp whose 16 rows all lie there skips the products. A
// block whose rows see no key of the visiting chunk returns at once where
// dq is updated in place, and writes dq_in (zeros at the first hop)
// otherwise. D is padded to 16, 32, 64 or 128. The first design (one
// thread a row, f32 FMA, every padded row computed) took 0.664 ms a seq:4
// carry hop and 0.904 ms the first hop (NVIDIA H100 80GB HBM3, 700 W).

#include "common.cuh"
#include "flash_tiles.cuh"

constexpr int RQ_ROWS = 64;  // K: query rows per block, one per thread
constexpr int RQ_KEYS = 32;  // K: keys per shared-memory tile
constexpr int RK_ROWS = 64;  // M: key rows per block, one per thread
constexpr int RK_QRYS = 32;  // M: queries per shared-memory tile

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

// Stage keys [k0, k0 + RQ_KEYS) of a chunk as f32; keys at or past t_valid
// load as zeros (they are masked).
template <int DP>
__device__ __forceinline__ void load_kv_tile(float (*ks)[DP], float (*vs)[DP],
                                             const __nv_bfloat16* k, const __nv_bfloat16* v,
                                             size_t base, int k0, int t_valid, int D) {
  for (int i = threadIdx.x; i < RQ_KEYS * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    const bool in = k0 + r < t_valid && c < D;
    const size_t off = base + (size_t)(k0 + r) * D + c;
    ks[r][c] = in ? __bfloat162float(k[off]) : 0.f;
    vs[r][c] = in ? __bfloat162float(v[off]) : 0.f;
  }
}

// Kernel K. acc_in/m_in/l_in may alias acc/m/l (the carry updated in
// place): each thread reads its own row before it writes it.
template <int DP>
__global__ void __launch_bounds__(RQ_ROWS) ring_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* acc_in, const float* m_in,
    const float* l_in, float* acc_out, float* m_out, float* l_out, int P, int BH, int Tp,
    int D, int t_valid, int pos0, int n_ring, int hop, float scale) {
  __shared__ __align__(16) float ks[RQ_KEYS][DP];
  __shared__ __align__(16) float vs[RQ_KEYS][DP];
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int q0 = blockIdx.x * RQ_ROWS;
  const int row = q0 + threadIdx.x;
  const bool live = row < Tp;
  const int gq = it.q_start + row;  // the row's global position
  const size_t qrow = it.q_off + (size_t)row * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = live && d < D;
    qr[d] = in ? __bfloat162float(q[qrow + d]) : 0.f;
    acc[d] = (in && acc_in) ? acc_in[qrow + d] : 0.f;
  }
  float m = GMT_NEG_INF, l = 0.f;
  if (live && m_in) {
    m = m_in[it.row_off + row];
    l = l_in[it.row_off + row];
  }

  const int kv_end = live_keys(it, min(q0 + RQ_ROWS, Tp) - 1, t_valid);
  for (int k0 = 0; k0 < kv_end; k0 += RQ_KEYS) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<DP>(ks, vs, k, v, it.kv_off, k0, t_valid, D);
    __syncthreads();

    // some key here lies past some row, or past t_valid
    const bool edge = it.k_start + k0 + RQ_KEYS - 1 > it.q_start + q0 || k0 + RQ_KEYS > t_valid;
    float s[RQ_KEYS];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < RQ_KEYS; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      dot *= scale;
      if (edge && (it.k_start + k0 + j > gq || k0 + j >= t_valid)) dot = GMT_NEG_INF;
      s[j] = dot;
      m_new = fmaxf(m_new, dot);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < RQ_KEYS; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) acc_out[qrow + d] = acc[d];
    m_out[it.row_off + row] = m;
    l_out[it.row_off + row] = l;
  }
}

// ---------------------------------------------------------------- Kernel L

constexpr int RL_ROWS = 64;      // query rows a block, 16 a warp
constexpr int RL_THREADS = 128;  // four warps
constexpr float RL_LOG2E = 1.4426950408889634f;

// L's tiling of one D bucket: K/V tiles of SROWS keys (32 at DP = 128,
// where the accumulators take the registers) and, at DP = 32 (every path's
// width), the register cap that lets MINB blocks share an SM, as Kernel E's.
template <int DP>
struct DqHopPlan {
  static constexpr int SROWS = DP > 64 ? 32 : 64;
  static constexpr int MINB = DP == 32 ? 6 : 1;
  static constexpr int LD = DP + 8, KD = DP / 16, STILE = SROWS * LD;
  // its own q and dO tiles, then two stages of (K, V)
  static constexpr size_t SMEM = (size_t)(2 * RL_ROWS * LD + 4 * STILE) * 2;
};

// L's work for one warp on one K/V tile (keys k0 .. of the visiting chunk):
// over each 16-key chunk, P and dS of the warp's rows wr0 .. wr0 + 15, then
// acc += dS k. diag = q_start - k_start: key kk is live for row r where kk
// <= diag + r and kk < t_valid. EDGE: the tile reaches past the block's
// first row or past t_valid, so a chunk wholly past the warp's rows (or
// t_valid) is skipped and the rest are masked; an inner tile takes neither
// test.
template <int DP, bool EDGE>
__device__ __forceinline__ void dq_hop_tile(float (&acc)[DP / 8][4],
                                            const unsigned (&qa)[DP / 16][4],
                                            const unsigned (&doa)[DP / 16][4],
                                            const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            int k0, int wr0, int diag, int t_valid, float sl2,
                                            const float (&lg)[2], const float (&dl)[2]) {
  using PL = DqHopPlan<DP>;
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int cc = 0; cc < PL::SROWS / 16; ++cc) {
    const int kc0 = k0 + 16 * cc;  // the chunk's first key
    if (EDGE && (kc0 > diag + wr0 + 15 || kc0 >= t_valid)) continue;
    float s[2][4], dp[2][4];
    ft_scores<PL::KD, PL::LD>(s, qa, ks, 16 * cc);
    ft_scores<PL::KD, PL::LD>(dp, doa, vs, 16 * cc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, key = kc0 + 8 * j + c + (e & 1);
        float p = ft_exp2(fmaf(s[j][e], sl2, -lg[h]));
        if (EDGE && (key > diag + wr0 + g + 8 * h || key >= t_valid)) p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]);  // dS
      }
    unsigned hi[4], lo[4];
    ft_split(s, hi, lo);
    ft_accum<DP, PL::LD>(acc, hi, lo, ks, 16 * cc);
  }
}

// Kernel L. dq_in may alias dq_out (in place): each thread reads its own
// elements before it writes them.
template <int DP>
__global__ void __launch_bounds__(RL_THREADS, DqHopPlan<DP>::MINB) ring_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* dq_in,
    float* dq_out, int P, int BH, int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
    float scale) {
  using PL = DqHopPlan<DP>;
  constexpr int LD = PL::LD, KD = PL::KD, BKV = PL::SROWS, TILE = PL::STILE;
  extern __shared__ __align__(16) unsigned char rl_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(rl_smem);
  __nv_bfloat16* dos = qs + RL_ROWS * LD;
  __nv_bfloat16* ring = dos + RL_ROWS * LD;  // stage s: K at ring + 2 s TILE, V after it
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RL_ROWS;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const int diag = it.q_start - it.k_start;
  // keys that a row of the tile below t_valid sees
  const int kv_end = q0 < t_valid ? live_keys(it, min(q0 + RL_ROWS, t_valid) - 1, t_valid) : 0;
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
    ft_load_tile<RL_ROWS, DP, RL_THREADS>(qs, q + it.q_off, q0, t_valid, D);
    ft_load_tile<RL_ROWS, DP, RL_THREADS>(dos, dout + it.q_off, q0, t_valid, D);
    ft_load_tile<BKV, DP, RL_THREADS>(ring, kb, 0, t_valid, D);
    ft_load_tile<BKV, DP, RL_THREADS>(ring + TILE, vb, 0, t_valid, D);
    gmt_cp_async_commit();
    // lse * log2(e) and delta of this thread's rows g and g + 8 (0 from t_valid)
    float lg[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr0 + g + 8 * h;
      lg[h] = row < t_valid ? lse[it.row_off + row] * RL_LOG2E : 0.f;
      dl[h] = row < t_valid ? delta[it.row_off + row] : 0.f;
    }
    gmt_cp_async_wait<0>();
    __syncthreads();

    unsigned qa[KD][4], doa[KD][4];
    ft_a_frags<KD, LD>(qa, qs, 16 * warp);
    ft_a_frags<KD, LD>(doa, dos, 16 * warp);
    const float sl2 = scale * RL_LOG2E;
    for (int t = 0; t < n_tiles; ++t) {
      if (t > 0) {
        gmt_cp_async_wait<0>();
        // tile t has landed for every thread, and every warp is past tile
        // t - 1, whose stage the next copies refill
        __syncthreads();
      }
      if (t + 1 < n_tiles) {
        __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
        ft_load_tile<BKV, DP, RL_THREADS>(st, kb, (t + 1) * BKV, t_valid, D);
        ft_load_tile<BKV, DP, RL_THREADS>(st + TILE, vb, (t + 1) * BKV, t_valid, D);
        gmt_cp_async_commit();
      }
      if (wr0 >= t_valid) continue;  // the warp's rows keep dq_in
      const __nv_bfloat16* ks = ring + (t % 2) * 2 * TILE;
      const int k0 = t * BKV;
      if (k0 + BKV - 1 > diag + q0 || k0 + BKV > t_valid)
        dq_hop_tile<DP, true>(acc, qa, doa, ks, ks + TILE, k0, wr0, diag, t_valid, sl2, lg, dl);
      else
        dq_hop_tile<DP, false>(acc, qa, doa, ks, ks + TILE, k0, wr0, diag, t_valid, sl2, lg, dl);
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

// Kernel M. dk_in/dv_in may alias dk_out/dv_out.
template <int DP>
__global__ void __launch_bounds__(RK_ROWS) ring_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* dk_in,
    const float* dv_in, float* dk_out, float* dv_out, int P, int BH, int Tp, int D,
    int t_valid, int pos0, int n_ring, int hop, float scale) {
  __shared__ __align__(16) float qs[RK_QRYS][DP];
  __shared__ __align__(16) float dos[RK_QRYS][DP];
  __shared__ float ls[RK_QRYS];
  __shared__ float dls[RK_QRYS];
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int kt0 = blockIdx.x * RK_ROWS;
  const int key = kt0 + threadIdx.x;
  const bool in_mem = key < Tp;
  const bool valid = key < t_valid;  // keys past t_valid are masked for every query
  const int gk = it.k_start + key;
  const size_t krow = it.kv_off + (size_t)key * D;

  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = valid && d < D;
    kr[d] = in ? __bfloat162float(k[krow + d]) : 0.f;
    vr[d] = in ? __bfloat162float(v[krow + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // The first query that sees any key of the tile, the transpose of the
  // live bound: global q_start + row >= k_start + kt0. A tile wholly past
  // t_valid sees none. Rows at or past t_valid add exactly 0 (dO = 0).
  const int q_lo = max(0, it.k_start + kt0 - it.q_start);
  const int q_hi = kt0 < t_valid ? t_valid : 0;
  for (int q0 = q_lo; q0 < q_hi; q0 += RK_QRYS) {
    __syncthreads();
    for (int i = threadIdx.x; i < RK_QRYS * DP; i += RK_ROWS) {
      const int r = i / DP, c = i % DP;
      const bool in = q0 + r < q_hi && c < D;
      const size_t off = it.q_off + (size_t)(q0 + r) * D + c;
      qs[r][c] = in ? __bfloat162float(q[off]) : 0.f;
      dos[r][c] = in ? __bfloat162float(dout[off]) : 0.f;
    }
    if (threadIdx.x < RK_QRYS) {
      const bool in = q0 + threadIdx.x < q_hi;
      ls[threadIdx.x] = in ? lse[it.row_off + q0 + threadIdx.x] : 0.f;
      dls[threadIdx.x] = in ? delta[it.row_off + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // some query here precedes some key of the tile
    const bool edge = it.q_start + q0 < it.k_start + kt0 + RK_ROWS - 1;
#pragma unroll(DP <= 32 ? RK_QRYS : 1)
    for (int j = 0; j < RK_QRYS; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(kr[d], qs[j][d], s);
        dp = fmaf(vr[d], dos[j][d], dp);
      }
      float p = expf(s * scale - ls[j]);
      if ((edge && it.q_start + q0 + j < gk) || !valid) p = 0.f;
      // a query row past q_hi has qs = dos = 0 and ls = dls = 0: p = 1 and
      // ds = 0 there, so it adds exactly 0 below
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dva[d] = fmaf(p, dos[j][d], dva[d]);
        dka[d] = fmaf(ds, qs[j][d], dka[d]);
      }
    }
  }

  if (in_mem) {
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D) {
        dk_out[krow + d] = (dk_in ? dk_in[krow + d] : 0.f) + dka[d] * scale;
        dv_out[krow + d] = (dv_in ? dv_in[krow + d] : 0.f) + dva[d];
      }
    }
  }
}

// launch KERNEL<DP> for the smallest bucket DP >= D
#define RING_DISPATCH_D(KERNEL, GRID, BLOCK, STREAM, ...)                    \
  do {                                                                       \
    if (D <= 8)                                                              \
      KERNEL<8><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__);                    \
    else if (D <= 16)                                                        \
      KERNEL<16><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__);                   \
    else if (D <= 32)                                                        \
      KERNEL<32><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__);                   \
    else if (D <= 64)                                                        \
      KERNEL<64><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__);                   \
    else                                                                     \
      KERNEL<128><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__);                  \
  } while (0)

// K: one hop for P ring positions; acc (P, BH, Tp, D), m, l (P, BH, Tp) f32.
// acc_in, m_in, l_in null: the first hop.
extern "C" int gmt_ring_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, const float* acc_in, const float* m_in,
                            const float* l_in, float* acc, float* m, float* l, int P, int BH,
                            int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
                            float scale, cudaStream_t stream) {
  const dim3 grid((Tp + RQ_ROWS - 1) / RQ_ROWS, BH, P);
  RING_DISPATCH_D(ring_fwd_kernel, grid, RQ_ROWS, stream, q, k, v, acc_in, m_in, l_in, acc, m,
                  l, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
}

template <int DP>
static int launch_ring_dq(dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                          const __nv_bfloat16* k, const __nv_bfloat16* v,
                          const __nv_bfloat16* dout, const float* lse, const float* delta,
                          const float* dq_in, float* dq, int P, int BH, int Tp, int D,
                          int t_valid, int pos0, int n_ring, int hop, float scale) {
  constexpr size_t smem = DqHopPlan<DP>::SMEM;
  const cudaError_t e = gmt_allow_smem(ring_bwd_dq_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  ring_bwd_dq_kernel<DP><<<grid, RL_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_in, dq, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
}

// L: dq (P, BH, Tp, D) f32; dq_in null: the first hop. D a multiple of 8,
// q, k, v and dout 16-byte aligned, dq_in and dq 8-byte aligned; D is
// padded to the smallest bucket >= D.
extern "C" int gmt_ring_bwd_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const __nv_bfloat16* dout,
                               const float* lse, const float* delta, const float* dq_in,
                               float* dq, int P, int BH, int Tp, int D, int t_valid, int pos0,
                               int n_ring, int hop, float scale, cudaStream_t stream) {
  if (D % 8 || D < 8 || D > 128) return cudaErrorInvalidValue;
  const dim3 grid((Tp + RL_ROWS - 1) / RL_ROWS, BH, P);
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
  const dim3 grid((Tp + RK_ROWS - 1) / RK_ROWS, BH, P);
  RING_DISPATCH_D(ring_bwd_dkv_kernel, grid, RK_ROWS, stream, q, k, v, dout, lse, delta, dk_in,
                  dv_in, dk, dv, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
}
