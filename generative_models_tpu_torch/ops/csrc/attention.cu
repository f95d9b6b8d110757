// Kernel C: causal flash-attention forward, for sm_90a.
//
// Replaces: generative_models_tpu/ops/attention.py _flash_kernel (:148,
// called by _flash_forward :172) and _flash_kernel_streamed (:312, called by
// _flash_forward_streamed :353). The TPU needed two plans (_plan :67) because
// of its VMEM budget; here one kernel covers every T.
//
// Computes o = softmax(q k^T * scale, causal) v and the row logsumexp, with
// q, k, v (BH, T, D) bf16 and o (BH, T, D), lse (BH, T) f32.
//
// What bounds it on an H100: at the pixel_transformer shape (BH=256, T=784,
// D=32) the causal work is ~10 GFLOP against ~65 MB of traffic, so the
// roofline puts it on the memory side (~20 us at 3.35 TB/s). At D=32 the
// arithmetic per score is small and the kernel is really bound by issuing
// the FMAs and shared-memory reads of the score and value products.
// The design:
//   * one block per (bh, 64-row query tile), one thread per query row: q and
//     the output accumulator stay in registers, and the online (m, l) softmax
//     needs no cross-thread reduction;
//   * K/V tiles of 32 keys are staged in shared memory as f32 and read as
//     broadcasts (every thread of a warp reads the same key), so each key is
//     loaded from device memory once per query tile;
//   * the KV loop stops at the tile's last row (causal skipping), and only
//     tiles that reach past the tile's first row apply the mask; rows and
//     keys past T are masked, so T needs no padding and no copies;
//   * query tiles are issued longest-first, so the short causal tiles fill
//     the tail of the grid;
//   * D is padded in registers to a bucket (8, 16, 32, 64, 128) with zeros,
//     so every register array is indexed at compile time.
// Plain FMA on f32, not mma/wgmma: a simple, correct first kernel; the tensor
// core path is later work (PERF.md records its time against the bound).

#include "common.cuh"

constexpr int FA_BQ = 64;  // query rows per block, one per thread
constexpr int FA_BK = 32;  // keys per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(FA_BQ) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int T, int D, float scale) {
  __shared__ __align__(16) float ks[FA_BK][DP];
  __shared__ __align__(16) float vs[FA_BK][DP];
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;  // longest tiles first
  const int row = q0 + threadIdx.x;
  const size_t base = (size_t)bh * T * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (row < T && d < D) ? __bfloat162float(q[base + (size_t)row * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = GMT_NEG_INF, l = 0.f;

  const int kv_end = min(T, q0 + FA_BQ);
  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < FA_BK * DP; i += FA_BQ) {
      const int r = i / DP, c = i % DP;
      const bool in = k0 + r < T && c < D;
      const size_t off = base + (size_t)(k0 + r) * D + c;
      ks[r][c] = in ? __bfloat162float(k[off]) : 0.f;
      vs[r][c] = in ? __bfloat162float(v[off]) : 0.f;
    }
    __syncthreads();

    const bool diag = k0 + FA_BK - 1 > q0;  // some key here lies past some row
    float s[FA_BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      dot *= scale;
      if (diag && k0 + j > row) dot = GMT_NEG_INF;  // also masks keys >= T
      s[j] = dot;
      m_new = fmaxf(m_new, dot);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (row < T) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) o[base + (size_t)row * D + d] = acc[d] / l;
    lse[(size_t)bh * T + row] = m + logf(l);
  }
}

extern "C" int gmt_flash_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, float* o, float* lse, int BH,
                             int T, int D, float scale, cudaStream_t stream) {
  const dim3 grid((T + FA_BQ - 1) / FA_BQ, BH);
  if (D <= 8)
    flash_fwd_kernel<8><<<grid, FA_BQ, 0, stream>>>(q, k, v, o, lse, T, D, scale);
  else if (D <= 16)
    flash_fwd_kernel<16><<<grid, FA_BQ, 0, stream>>>(q, k, v, o, lse, T, D, scale);
  else if (D <= 32)
    flash_fwd_kernel<32><<<grid, FA_BQ, 0, stream>>>(q, k, v, o, lse, T, D, scale);
  else if (D <= 64)
    flash_fwd_kernel<64><<<grid, FA_BQ, 0, stream>>>(q, k, v, o, lse, T, D, scale);
  else
    flash_fwd_kernel<128><<<grid, FA_BQ, 0, stream>>>(q, k, v, o, lse, T, D, scale);
  return cudaGetLastError();
}
