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
// q, k, v, dO are bf16; every sum and P and dS are f32. (The TPU kernel
// rounds P and dS to bf16 before its products, :308 and :717-721; Kernels
// C, D and E keep them f32 too, and the plain versions in ops/attention.py
// round at the same places as these kernels.)
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
// part. L and M move ~103 MB and ~137 MB a hop. On FMA units the products
// bound them, as in Kernels C, D and E: each score is a D-long chain of one
// shared-memory broadcast read and one FMA per element. The design follows
// Kernel C: one block per (ring position, bh, 64-row query tile), one thread
// per row (per key row in M), q, dO and the accumulators in registers, K/V
// (Q/dO in M) tiles of 32 staged in shared memory as f32, D padded in
// registers to a bucket (8, 16, 32, 64, 128). Plain FMA on f32, not
// mma/wgmma: a simple, correct first kernel; PERF.md records its time
// against the bound.

#include "common.cuh"

constexpr int RQ_ROWS = 64;  // K, L: query rows per block, one per thread
constexpr int RQ_KEYS = 32;  // K, L: keys per shared-memory tile
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

// Kernel L. dq_in may alias dq_out.
template <int DP>
__global__ void __launch_bounds__(RQ_ROWS) ring_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* dq_in,
    float* dq_out, int P, int BH, int Tp, int D, int t_valid, int pos0, int n_ring, int hop,
    float scale) {
  __shared__ __align__(16) float ks[RQ_KEYS][DP];
  __shared__ __align__(16) float vs[RQ_KEYS][DP];
  const HopItem it = hop_item(blockIdx.z, blockIdx.y, P, BH, Tp, D, t_valid, pos0, n_ring, hop);
  const int q0 = blockIdx.x * RQ_ROWS;
  const int row = q0 + threadIdx.x;
  const bool live = row < Tp;
  const int gq = it.q_start + row;
  const size_t qrow = it.q_off + (size_t)row * D;

  float qr[DP], dor[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = live && d < D;
    qr[d] = in ? __bfloat162float(q[qrow + d]) : 0.f;
    dor[d] = in ? __bfloat162float(dout[qrow + d]) : 0.f;
    acc[d] = 0.f;
  }
  const float lr = live ? lse[it.row_off + row] : 0.f;
  const float dl = live ? delta[it.row_off + row] : 0.f;

  const int kv_end = live_keys(it, min(q0 + RQ_ROWS, Tp) - 1, t_valid);
  for (int k0 = 0; k0 < kv_end; k0 += RQ_KEYS) {
    __syncthreads();
    load_kv_tile<DP>(ks, vs, k, v, it.kv_off, k0, t_valid, D);
    __syncthreads();

    const bool edge = it.k_start + k0 + RQ_KEYS - 1 > it.q_start + q0 || k0 + RQ_KEYS > t_valid;
#pragma unroll(DP <= 32 ? RQ_KEYS : 1)
    for (int j = 0; j < RQ_KEYS; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      float p = expf(s * scale - lr);
      if (edge && (it.k_start + k0 + j > gq || k0 + j >= t_valid)) p = 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) dq_out[qrow + d] = (dq_in ? dq_in[qrow + d] : 0.f) + acc[d] * scale;
  }
}

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

// L: dq (P, BH, Tp, D) f32; dq_in null: the first hop.
extern "C" int gmt_ring_bwd_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const __nv_bfloat16* dout,
                               const float* lse, const float* delta, const float* dq_in,
                               float* dq, int P, int BH, int Tp, int D, int t_valid, int pos0,
                               int n_ring, int hop, float scale, cudaStream_t stream) {
  const dim3 grid((Tp + RQ_ROWS - 1) / RQ_ROWS, BH, P);
  RING_DISPATCH_D(ring_bwd_dq_kernel, grid, RQ_ROWS, stream, q, k, v, dout, lse, delta, dq_in,
                  dq, P, BH, Tp, D, t_valid, pos0, n_ring, hop, scale);
  return cudaGetLastError();
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
