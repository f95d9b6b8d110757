// Kernels D and E: causal flash-attention backward, for sm_90a.
//
// Replaces: generative_models_tpu/ops/attention.py _flash_bwd_kernel (:209,
// called by _flash_backward :244), _flash_bwd_dq_streamed (:389) and
// _flash_bwd_dkv_streamed (:418, both called by _flash_backward_streamed
// :454). The TPU kernel carried dK/dV from one grid step to the next in
// VMEM; Hopper runs blocks in no order, so this is the FlashAttention-2
// split: one kernel owns the query rows (dQ), the other the key rows (dK,
// dV). Neither needs atomics, and every sum runs in a fixed order, so the
// gradients are deterministic. One plan covers every T.
//
// Inputs: q, k, v, dO (BH, T, D) bf16 (dO rounded to the operand type, as
// the JAX package rounds it), o (BH, T, D) f32 and lse (BH, T) f32 from
// Kernel C. P = exp(q k^T * scale - lse), recomputed; dP = dO v^T;
// dS = P * (dP - delta) with delta = rowsum(dO * o); dQ = dS k * scale,
// dK = dS^T q * scale, dV = P^T dO, all f32. P and dS stay f32 (the TPU
// kernel rounds them to bf16 before its products; Kernel C keeps P in f32
// too): only q, k, v and dO are bf16 operands, and the plain version
// (ops/attention.py causal_attention_bwd_plain) rounds at the same places.
//
// What bounds it on an H100: at the pixel_transformer training shape
// (BH=256, T=784, D=32) each kernel moves ~104 MB (each input read once,
// each output written once; ~0.031 ms at 3.35 TB/s) against 15 GFLOP (E:
// three products) or 20 GFLOP (D: four) over the ~79M live (query, key)
// pairs (~0.015 and ~0.020 ms at the bf16 tensor-core peak): bound by bytes.
// The split recomputes S and dP in both kernels, seven products where the
// fused TPU kernel had five. On FMA units the products are what bounds
// them: each is a D-long chain of one shared-memory broadcast read and one
// FMA per element. The design:
//   * E (flash_bwd_dq_kernel) runs first: one block per (bh, 64-row query
//     tile), one thread per query row, q, dO and the dQ accumulator in
//     registers. Its prologue forms delta from the thread's own dO and o
//     row and writes it out for D. It walks K/V tiles of 32 keys, staged in
//     shared memory as f32, from 0 to the diagonal; tiles are issued
//     longest-first, as in Kernel C.
//   * D (flash_bwd_dkv_kernel): one block per (bh, 64-key tile), one thread
//     per key row, k, v and the dK, dV accumulators in registers. It walks
//     Q/dO tiles of 32 queries (with their lse and delta) from the diagonal
//     to T; key tiles near the start see the most queries and go first.
//   * Only tiles that cross the diagonal apply the causal mask. Rows and
//     keys past T load as zeros: a query row past T has q = dO = 0 and adds
//     exactly 0 to dK and dV, and a key past T is masked by causality, so T
//     needs no padding and no copies.
//   * D is padded in registers to a bucket (8, 16, 32, 64, 128), so every
//     register array is indexed at compile time. D holds four D-long rows a
//     thread and E three, so both spill past D=32 (ptxas reports it at the
//     build); there the loop over a tile's rows is not unrolled.
// Plain FMA on f32, not mma/wgmma: a simple, correct first kernel; PERF.md
// records its time against the bound.

#include "common.cuh"

constexpr int BQ_ROWS = 64;  // E: query rows per block, one per thread
constexpr int BQ_KEYS = 32;  // E: keys per shared-memory tile
constexpr int BK_ROWS = 64;  // D: key rows per block, one per thread
constexpr int BK_QRYS = 32;  // D: queries per shared-memory tile
// The loop over a shared tile's rows is unrolled whole up to D=32 only:
// past it the rows' registers spill anyway, and a whole unroll of 32 rows of
// 64- or 128-wide products takes ptxas minutes to build.

template <int DP>
__global__ void __launch_bounds__(BQ_ROWS) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int T, int D, float scale) {
  __shared__ __align__(16) float ks[BQ_KEYS][DP];
  __shared__ __align__(16) float vs[BQ_KEYS][DP];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_ROWS;  // longest tiles first
  const int row = q0 + threadIdx.x;
  const bool live = row < T;
  const size_t base = (size_t)bh * T * D;

  float qr[DP], dor[DP], acc[DP];
  float dl = 0.f;  // delta = rowsum(dO * o)
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = live && d < D;
    const size_t off = base + (size_t)row * D + d;
    qr[d] = in ? __bfloat162float(q[off]) : 0.f;
    dor[d] = in ? __bfloat162float(dout[off]) : 0.f;
    dl = fmaf(dor[d], in ? o[off] : 0.f, dl);
    acc[d] = 0.f;
  }
  const float l = live ? lse[(size_t)bh * T + row] : 0.f;
  if (live) delta[(size_t)bh * T + row] = dl;

  const int kv_end = min(T, q0 + BQ_ROWS);
  for (int k0 = 0; k0 < kv_end; k0 += BQ_KEYS) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BQ_KEYS * DP; i += BQ_ROWS) {
      const int r = i / DP, c = i % DP;
      const bool in = k0 + r < T && c < D;
      const size_t off = base + (size_t)(k0 + r) * D + c;
      ks[r][c] = in ? __bfloat162float(k[off]) : 0.f;
      vs[r][c] = in ? __bfloat162float(v[off]) : 0.f;
    }
    __syncthreads();

    const bool diag = k0 + BQ_KEYS - 1 > q0;  // some key here lies past some row
#pragma unroll(DP <= 32 ? BQ_KEYS : 1)
    for (int j = 0; j < BQ_KEYS; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      float p = expf(s * scale - l);
      if (diag && k0 + j > row) p = 0.f;  // also masks keys >= T
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) dq[base + (size_t)row * D + d] = acc[d] * scale;
  }
}

template <int DP>
__global__ void __launch_bounds__(BK_ROWS) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int T, int D, float scale) {
  __shared__ __align__(16) float qs[BK_QRYS][DP];
  __shared__ __align__(16) float dos[BK_QRYS][DP];
  __shared__ float ls[BK_QRYS];
  __shared__ float dls[BK_QRYS];
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK_ROWS;  // the first key tiles see the most queries
  const int key = k0 + threadIdx.x;
  const bool live = key < T;
  const size_t base = (size_t)bh * T * D;

  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const bool in = live && d < D;
    const size_t off = base + (size_t)key * D + d;
    kr[d] = in ? __bfloat162float(k[off]) : 0.f;
    vr[d] = in ? __bfloat162float(v[off]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // queries before k0 see none of this block's keys
  for (int q0 = k0; q0 < T; q0 += BK_QRYS) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK_QRYS * DP; i += BK_ROWS) {
      const int r = i / DP, c = i % DP;
      const bool in = q0 + r < T && c < D;
      const size_t off = base + (size_t)(q0 + r) * D + c;
      qs[r][c] = in ? __bfloat162float(q[off]) : 0.f;
      dos[r][c] = in ? __bfloat162float(dout[off]) : 0.f;
    }
    if (threadIdx.x < BK_QRYS) {
      const bool in = q0 + threadIdx.x < T;
      ls[threadIdx.x] = in ? lse[(size_t)bh * T + q0 + threadIdx.x] : 0.f;
      dls[threadIdx.x] = in ? delta[(size_t)bh * T + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    const bool diag = q0 < k0 + BK_ROWS - 1;  // some query here precedes some key
#pragma unroll(DP <= 32 ? BK_QRYS : 1)
    for (int j = 0; j < BK_QRYS; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(kr[d], qs[j][d], s);
        dp = fmaf(vr[d], dos[j][d], dp);
      }
      float p = expf(s * scale - ls[j]);
      if (diag && q0 + j < key) p = 0.f;
      // a query row past T has qs = dos = 0 (and ls = dls = 0): p = 1 and
      // ds = 0 there, so it adds exactly 0 below
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dva[d] = fmaf(p, dos[j][d], dva[d]);
        dka[d] = fmaf(ds, qs[j][d], dka[d]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D) {
        dk[base + (size_t)key * D + d] = dka[d] * scale;
        dv[base + (size_t)key * D + d] = dva[d];
      }
    }
  }
}

// launch KERNEL<DP> for the smallest bucket DP >= D
#define GMT_DISPATCH_D(KERNEL, GRID, BLOCK, STREAM, ...)                     \
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

// E: dq (BH, T, D) and delta (BH, T), both f32. Launch before D.
extern "C" int gmt_flash_bwd_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const float* o,
                                const __nv_bfloat16* dout, const float* lse,
                                float* delta, float* dq, int BH, int T, int D,
                                float scale, cudaStream_t stream) {
  const dim3 grid((T + BQ_ROWS - 1) / BQ_ROWS, BH);
  GMT_DISPATCH_D(flash_bwd_dq_kernel, grid, BQ_ROWS, stream, q, k, v, o, dout, lse,
                 delta, dq, T, D, scale);
  return cudaGetLastError();
}

// D: dk, dv (BH, T, D) f32, from the delta that E wrote.
extern "C" int gmt_flash_bwd_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                 const float* lse, const float* delta, float* dk,
                                 float* dv, int BH, int T, int D, float scale,
                                 cudaStream_t stream) {
  const dim3 grid((T + BK_ROWS - 1) / BK_ROWS, BH);
  GMT_DISPATCH_D(flash_bwd_dkv_kernel, grid, BK_ROWS, stream, q, k, v, dout, lse,
                 delta, dk, dv, T, D, scale);
  return cudaGetLastError();
}
