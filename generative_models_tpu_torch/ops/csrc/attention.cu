// Kernel C: causal flash-attention forward on the tensor cores, for sm_90a.
//
// Replaces: generative_models_tpu/ops/attention.py _flash_kernel (:148,
// called by _flash_forward :172) and _flash_kernel_streamed (:312, called by
// _flash_forward_streamed :353). The TPU needed two plans (_plan :67) because
// of its VMEM budget; here one kernel covers every T.
//
// Computes o = softmax(q k^T * scale, causal) v and the row logsumexp, with
// q, k, v (BH, T, D) bf16 and o (BH, T, D), lse (BH, T) f32. lse is in
// natural units: Kernels E and D recompute P = exp(S - lse) from it.
//
// P as a bf16 pair: a tensor-core product takes bf16 operands, and the TPU
// kernel rounds P to bf16 once before P v. That moves o by up to ~5e-3 at
// T=784, far past the port's contract (atol 2e-5 + rtol 2e-4 against the
// plain version, which keeps P in f32; tests/test_torch_attention.py pins
// it). So P is split in registers into hi = bf16(P) and lo = bf16(P - hi)
// and both products are summed in f32, as Kernels E and D carry P and dS:
// 12 mma.sync a warp for each 16 x 16 (row, key) chunk at D=32 (4 for S,
// 8 for P v), and P stays good to ~2^-16 relative. The row sum l adds the
// f32 P itself.
//
// What bounds it on an H100: at the pixel_transformer shape (BH=256, T=784,
// D=32) it moves ~65 MB (q, k, v read once, o and lse written once: 19.4
// us at 3.35 TB/s) against ~10 GFLOP over the ~79M live (query, key) pairs
// (10 us at the bf16 tensor-core peak, 150 us at the f32 CUDA-core rate:
// only the tensor cores can bring it near its bound), plus ~79M exp2 on the
// special-function units. mma.sync does not reach the peak on Hopper
// (wgmma does), each 64-key tile of a warp is one dependent chain (scores,
// row max, rescale, exp2, split, products), and at D=32 each score's
// softmax and split work on the CUDA cores weighs about as much as its
// share of the products, so those set the pace, not the bytes. The design
// is Kernel E's (attention_bwd.cu), from the warp routines of
// flash_tiles.cuh:
//   * one block of four warps per (bh, 64-row query tile), tiles issued
//     longest-first so the short causal tiles fill the tail of the grid;
//     each warp owns 16 query rows, q as mma A fragments in registers;
//   * K and V tiles of 64 keys (32 at D > 64, where the accumulators take
//     the registers) stream from key 0 to the diagonal by 16-byte cp.async
//     into a double-buffered ring, one barrier a tile;
//   * a tile's scores (ft_scores) are taken whole, then one online-softmax
//     step a tile in log2 units: the row max across the quad of lanes that
//     shares a row (each lane holds rows g and g + 8 and a quarter of their
//     columns), one rescale of acc and l, P = exp2(S * scale * log2(e) - m)
//     (ft_exp2), l += P, and acc += (hi + lo) v (ft_split, ft_accum);
//   * only a tile that reaches the block's diagonal (or T) takes the tests:
//     there a warp skips a 16-key chunk that lies wholly past its rows (or
//     past T) and masks the rest with NEG_INF (finite, so m - m_new is never
//     NaN); every other tile runs its chunks as one straight, unmasked run
//     of code. Rows and keys past T and the columns from D to the next
//     multiple of 16 load as zeros, so T needs no padding and no copies;
//   * D is padded to a bucket (16, 32, 64, 128) at compile time;
//   * every sum runs in a fixed order and there are no atomics, so two
//     launches on the same inputs give bitwise the same o and lse.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, row
// 3): 0.0971 ms at (64,4,784,32), the same with L2 flushed, 1.10x
// scaled_dot_product_attention's forward and 5.0x the byte bound; 0.0258 ms
// at (1,4,2048,32); 0.0051 ms at (64,8,49,32). The first design (one thread
// a query row, f32 K/V tiles and FMA on the CUDA cores) took 0.7053, 0.3232
// and 0.02807 ms.

#include "common.cuh"
#include "flash_tiles.cuh"

constexpr int FWD_ROWS = 64;      // query rows a block, 16 a warp
constexpr int FWD_THREADS = 128;  // four warps
constexpr float FWD_LOG2E = 1.4426950408889634f;
constexpr float FWD_LN2 = 0.6931471805599453f;

// The tiling of one D bucket: K/V tiles of SROWS keys, 32 at DP = 128 where
// the accumulators take the registers. At DP = 32, every path's width, the
// kernel is held to the registers that let MINB blocks share an SM (the
// cap and the tile depth were chosen by ops/knob_sweep.py: PERF.md section
// 6); the other buckets take what ptxas gives them.
template <int DP>
struct FwdPlan {
  static constexpr int SROWS = DP > 64 ? 32 : 64;
  static constexpr int LD = DP + 8, KD = DP / 16, STILE = SROWS * LD;
  static constexpr int MINB = DP == 32 ? 4 : 1;
  // its own q tile, then two stages of (K, V)
  static constexpr size_t SMEM = (size_t)(FWD_ROWS * LD + 4 * STILE) * 2;
};

// One warp's work on one K/V tile (keys k0 ..) for its rows row0 .. row0 +
// 15: the online-softmax step (m in log2 units, l this lane's share of the
// row sum) and acc += P v. EDGE: the tile reaches past the block's first
// row (or T), as in attention_bwd.cu's dq_tile.
template <int DP, bool EDGE>
__device__ __forceinline__ void fwd_tile(float (&acc)[DP / 8][4], float (&m)[2], float (&l)[2],
                                         const unsigned (&qa)[DP / 16][4],
                                         const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                         int k0, int row0, int T, float sl2) {
  using P = FwdPlan<DP>;
  constexpr int NC = P::SROWS / 16;
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  float s[NC][2][4];
  float mx[2] = {GMT_NEG_INF, GMT_NEG_INF};
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int kc0 = k0 + 16 * cc;  // the chunk's first key
    if (EDGE && (kc0 > row0 + 15 || kc0 >= T)) continue;
    ft_scores<P::KD, P::LD>(s[cc], qa, ks, 16 * cc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EDGE && kc0 + 8 * j + c + (e & 1) > row0 + g + 8 * (e / 2))
          s[cc][j][e] = GMT_NEG_INF;  // also masks keys >= T for rows < T
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
    if (EDGE && (kc0 > row0 + 15 || kc0 >= T)) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ft_exp2(fmaf(s[cc][j][e], sl2, -m[e / 2]));
        l[e / 2] += p;
        s[cc][j][e] = p;
      }
    unsigned hi[4], lo[4];
    ft_split(s[cc], hi, lo);
    ft_accum<DP, P::LD>(acc, hi, lo, vs, 16 * cc);
  }
}

template <int DP>
__global__ void __launch_bounds__(FWD_THREADS, FwdPlan<DP>::MINB) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int T,
    int D, float scale) {
  using P = FwdPlan<DP>;
  constexpr int LD = P::LD, BKV = P::SROWS, TILE = P::STILE;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fwd_smem);
  __nv_bfloat16* ring = qs + FWD_ROWS * LD;  // stage s: K at ring + 2 s TILE, V after it
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_ROWS;  // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const size_t base = (size_t)bh * T * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int n_tiles = (min(T, q0 + FWD_ROWS) + BKV - 1) / BKV;

  ft_load_tile<FWD_ROWS, DP, FWD_THREADS>(qs, q + base, q0, T, D);
  ft_load_tile<BKV, DP, FWD_THREADS>(ring, kb, 0, T, D);
  ft_load_tile<BKV, DP, FWD_THREADS>(ring + TILE, vb, 0, T, D);
  gmt_cp_async_commit();
  gmt_cp_async_wait<0>();
  __syncthreads();

  unsigned qa[P::KD][4];
  ft_a_frags<P::KD, LD>(qa, qs, 16 * warp);
  const float sl2 = scale * FWD_LOG2E;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {GMT_NEG_INF, GMT_NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      gmt_cp_async_wait<0>();
      // tile t has landed for every thread, and every warp is past tile
      // t - 1, whose stage the next copies refill
      __syncthreads();
    }
    if (t + 1 < n_tiles) {
      __nv_bfloat16* st = ring + ((t + 1) % 2) * 2 * TILE;
      ft_load_tile<BKV, DP, FWD_THREADS>(st, kb, (t + 1) * BKV, T, D);
      ft_load_tile<BKV, DP, FWD_THREADS>(st + TILE, vb, (t + 1) * BKV, T, D);
      gmt_cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (t % 2) * 2 * TILE;
    if ((t + 1) * BKV - 1 > q0)  // some key here lies past the block's first row
      fwd_tile<DP, true>(acc, m, l, qa, ks, ks + TILE, t * BKV, wr0, T, sl2);
    else
      fwd_tile<DP, false>(acc, m, l, qa, ks, ks + TILE, t * BKV, wr0, T, sl2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = wr0 + g + 8 * h;
    if (row >= T) continue;
    float* dst = o + base + (size_t)row * D + c;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * h] / l[h], acc[n][2 * h + 1] / l[h]);
    if (c == 0) lse[(size_t)bh * T + row] = m[h] * FWD_LN2 + logf(l[h]);
  }
}

template <int DP>
int launch_fwd(int BH, cudaStream_t stream, const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, float* o, float* lse, int T, int D, float scale) {
  constexpr size_t smem = FwdPlan<DP>::SMEM;
  const cudaError_t e = gmt_allow_smem(flash_fwd_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + FWD_ROWS - 1) / FWD_ROWS, BH);
  flash_fwd_kernel<DP><<<grid, FWD_THREADS, smem, stream>>>(q, k, v, o, lse, T, D, scale);
  return cudaGetLastError();
}

// o (BH, T, D) and lse (BH, T), both f32, from q, k, v (BH, T, D) bf16 with
// rows 16-byte aligned (D a multiple of 8). D is padded to the smallest
// bucket >= D.
extern "C" int gmt_flash_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, float* o, float* lse, int BH, int T, int D,
                             float scale, cudaStream_t stream) {
  auto go = D <= 16 ? launch_fwd<16> : D <= 32 ? launch_fwd<32> : D <= 64 ? launch_fwd<64>
                                                                           : launch_fwd<128>;
  return go(BH, stream, q, k, v, o, lse, T, D, scale);
}
