// Kernels A (ln_matmul) and B (block_tail): the dense halves of one
// KV-cached transformer decode step, for sm_90a.
//
// Replaces: generative_models_tpu/ops/decode_fused.py _ln_matmul_kernel (:46,
// called by ln_matmul :55) and _block_tail_kernel (:71, called by block_tail
// :95).
//
// What bounds them on an H100: nothing the card is short of. At the serving
// shapes (B=64 rows, C=128 or 256) one launch moves under 2 MB (the bf16
// weights are most of it, and they stay in the 50 MB L2 across decode
// steps) and does at most 75 MFLOP, so a launch costs its fixed latency.
//
// A (ln_matmul) has two routes, by N (plan_ln_matmul in ops/decode_fused.py
// reckons the same):
//   * N >= 8, on the tensor cores (ln_matmul_kernel): one block of LM_COLS / 8
//     warps a (16-row strip, LM_COLS-column slice). At entry the block issues
//     its weight slice's 16-byte cp.async copies, 64 rows of w a stage, every
//     stage at once where the slice has at most LM_STAGES of them (C <= 256:
//     every path shape), so the weight flies while LN runs, and one wait and
//     one barrier serve them all; wider C streams through a ring of LM_STAGES
//     stages, one barrier a stage. b is read at entry, so no load waits behind
//     a barrier. Each warp reads two rows of x once into registers, takes LN
//     from there (two-pass mean and variance, eps 1e-6, row sums by a shuffle
//     butterfly) and writes the bf16 rows to shared memory at a row stride of
//     C + 8 (rounded up to 16), so ldmatrix reads them without bank conflicts.
//     Then each warp owns an 8-column group: mma.sync m16n8k16 through
//     gmt_mma_bf16, A by ldmatrix from the rows, B by ldmatrix.trans from the
//     (in, out) stage, the even and the odd k steps into two sums (two
//     dependent chains of half the length); the epilogue adds them and b and
//     masks rows past B and columns past N. The first design re-normalised its
//     rows in every column block, reading x from device memory three times,
//     and started its weight loads only after LN, behind a barrier: two
//     dependent round trips and an f32 FMA chain of K / splits x 8 rows.
//   * N < 8, on the CUDA cores (ln_matmul_dot_kernel; pixel_transformer's
//     head, N = 1): an m16n8 tile would be 7/8 zeros, so a warp takes a
//     row: LN and the C-long dot products from registers, one shuffle
//     reduction an output, no shared memory and no barrier.
// 16-byte loads of x and w only where N % 8 == 0, C % 4 == 0 and x and w
// are 16-byte aligned (VEC); plain loads otherwise. C up to 6096 (the rows
// and LM_STAGES stages within a block's shared memory). No atomics and no
// split K: A is bitwise the same run to run. Rounding as the plain version:
// bf16(LN(x) * scale + bias) and bf16(w) as operands, f32 sums and output.
// The first design took 6.553 us at (64,128) -> 384 and 4.522 us at -> 1
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// B (block_tail) spreads the weights over a cluster, not the rows over
// blocks, and multiplies on the tensor cores:
//   * one cluster of n blocks (8 up to C = 128, else 16: plan_block_tail in
//     ops/decode_fused.py) owns a 16-row strip, one m16 tile (4 clusters at
//     serve_bs=64; rows past B are zero-filled). Block r owns proj's output
//     columns [rP, rP+P) (h1's, and the output's), fc1's hidden columns
//     [rF, rF+F), and fc2 over those same F hidden rows, so the hidden
//     slice never leaves its block; per SM the weight stream is 1/n of the
//     whole (36 KB of 288 at C=128). The strip is 16 rows, not 64, because
//     a launch is a chain of latency-bound steps, each a few instructions a
//     thread: at 64 rows on one cluster (8 SMs) every step carried 4x the
//     work on one warp a scheduler (PERF.md, section 6);
//   * a producer warp streams the block's weight slices from its start
//     through a ring of `slots` 64 x 64 bf16 tiles (16-byte cp.async; plain
//     loads where C is not a multiple of 16 or a pointer not 16-byte
//     aligned, VEC false), each slot with a full and an empty mbarrier, so
//     the stalls of issuing the copies (the SM's queue of loads in flight
//     fills) never hold the products up; at the plan's C <= 256 every tile
//     has a slot;
//   * eight consumer warps, an 8-column group of each 64-column chunk each:
//     every product is mma.sync m16n8k16 (bf16 operands, f32 sums), A from
//     the bf16 rows in shared memory by ldmatrix, B from the (in, out)
//     weight tiles by ldmatrix.trans;
//   * the cluster's blocks exchange through distributed shared memory by
//     stores only, each before a cluster barrier: proj's epilogue writes
//     each h1 value into every block's H1 rows, so LN2 (two-pass mean and
//     variance, eps 1e-6, row sums by a shuffle butterfly) reads them
//     locally; fc2's epilogue writes each partial sum into the owning
//     block's inbox, which sums its columns over the ranks in rank order,
//     then + bfc2 and + h1, so B is bitwise the same run to run. Remote
//     loads, tried first, put a round trip on the path at each exchange;
//   * barrier 0 (every block has started) is arrived at the start and
//     awaited just before the first remote store; the producer, which
//     writes nothing another block reads, arrives at barrier 1 before it
//     streams, so the consumers never wait for it there.
// The rounding points are the plain version's: bf16(y), bf16(LN2(h1)) and
// bf16(gelu_tanh(.)) as operands, f32 sums, h1 and the output in f32; the
// gelu's 0.5 (1 + tanh u) is taken as 1 / (1 + exp(-2u)) on the fast
// exponential (tanhf's instruction chain held the fc1 epilogue up, PERF.md).
//
// Shared memory of a block (bytes; plan_block_tail reckons the same; Cp = C
// rounded up to 16):
//   mbarriers  2 x 24 x 8 = 384
//   Y          16 (Cp + 8) 2: bf16(y) rows, then bf16(LN2(h1))
//   HID        16 (F + 8) 2: the bf16 hidden slice
//   H1         16 Cp 4: h1's rows, every block's columns
//   IN         n 16 P 4: fc2's partial sums of this block's columns, a rank each
//   vectors    (2P + F + 2Cp) 4: bproj's, bfc1's and bfc2's slices, LN2's scale, bias
//   ring       slots 64 (64 + 8) 2 = 9216 each
// C=128, n=8 (P=16, F=64): 384 + 4352 + 2304 + 8192 + 8192 + 1408 + 6 x 9216 =
// 80128. C=256, n=16 (P=16, F=64): 156928, all 12 tiles resident; n=8 would
// take 19 slots of its 20 tiles. C=512, n=16: 15 slots of 40 tiles, 230016.
// The first design (4 rows a block, 16 blocks at B=64, every block
// streaming all three weights through f32 FMA loops; NVIDIA H100 80GB HBM3,
// 700 W) took 23.15 us at C=128 and 73.12 us at C=256.
// The ragged edges (rows past B, columns past N or C) are masked in the
// kernels.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block can have

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu's default (tanh) approximation, 0.5 (1 + tanh(u)) written as
  // 1 / (1 + exp(-2u)) with the fast exponential (within ~1e-6 of tanhf's,
  // in a few instructions; the result is rounded to bf16)
  const float u = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
  return __fdividef(v, 1.f + __expf(-2.f * u));
}

// out[j] = the sum of t[j] over the warp's 32 lanes, for each of R rows
// (R a power of 2 up to 16): a butterfly that halves the rows at each of
// the first log2 R levels (R - 1 shuffles, independent within a level), the
// full sum over the rest, then each row's total broadcast from its lanes.
template <int R>
__device__ __forceinline__ void bt_rows_sum(float (&t)[R], float (&out)[R]) {
  constexpr int LOG = R >= 16 ? 4 : R >= 8 ? 3 : R >= 4 ? 2 : R >= 2 ? 1 : 0;
  static_assert(R == 1 << LOG, "R a power of 2 up to 16");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int l = 0; l < LOG; ++l) {
    const int half = R >> (l + 1), bit = 16 >> l;
    const bool up = lane & bit;  // keep rows half.. (else ..half), send the others
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? t[k] : t[half + k];
      t[k] = (up ? t[half + k] : t[k]) + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
#pragma unroll
  for (int bit = 16 >> LOG; bit > 0; bit >>= 1) t[0] += __shfl_xor_sync(0xffffffffu, t[0], bit);
  // lane l now holds row l >> (5 - LOG)'s total
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = __shfl_sync(0xffffffffu, t[0], j << (5 - LOG));
}

// ---------------------------------------------------------------- Kernel A

constexpr int LM_ROWS = 16, LM_COLS = 64;  // a block's strip of x and slice of w's columns
constexpr int LM_WARPS = LM_COLS / 8;      // an 8-column group a warp
constexpr int LM_THREADS = 32 * LM_WARPS;
constexpr int LM_KC = 64;                  // rows of w a stage
constexpr int LM_WLD = LM_COLS + 8;        // a stage's row stride: ldmatrix rows on distinct banks
constexpr int LM_STAGE = LM_KC * LM_WLD;   // bf16 elements of a stage
constexpr int LM_STAGES = 4;               // stages in flight where C > 4 LM_KC
constexpr int LM_DOT_WARPS = 4;            // the dot route: a row a warp
constexpr int LM_DOT_MAX_N = 7;            // the dot route takes N < 8
static_assert(LM_ROWS % 16 == 0 && LM_ROWS % LM_WARPS == 0, "whole m16 tiles, rows a warp");

// The column of value i of a lane's VPL values of a row, W columns a load.
template <int W>
__device__ __forceinline__ int lm_col(int i) {
  return (threadIdx.x % 32 + 32 * (i / W)) * W + i % W;
}

// Rows m .. m + R - 1 of x (zero from row B and column C on) into v, 4
// columns a load where VEC, VPL values a lane a row (C <= 32 VPL); each
// row's mean and 1 / sqrt(var + 1e-6), two-pass, as the plain version's _ln.
template <bool VEC, int VPL, int R>
__device__ __forceinline__ void lm_rows_stats(const float* __restrict__ x, int m, int B, int C,
                                              float (&v)[R][VPL], float (&mean)[R],
                                              float (&rs)[R]) {
  constexpr int W = VEC ? 4 : 1;
#pragma unroll
  for (int i = 0; i < VPL; i += W) {
    const int c = lm_col<W>(i);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float* src = x + (size_t)(m + j) * C + c;
      const bool in = m + j < B && c < C;
      if constexpr (VEC) {
        const float4 f = in ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[j][i] = f.x, v[j][i + 1] = f.y, v[j][i + 2] = f.z, v[j][i + 3] = f.w;
      } else {
        v[j][i] = in ? src[0] : 0.f;
      }
    }
  }
  float t[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    t[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) t[j] += v[j][i];
  }
  bt_rows_sum<R>(t, mean);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mean[j] /= C;
    t[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float d = lm_col<W>(i) < C ? v[j][i] - mean[j] : 0.f;
      t[j] += d * d;
    }
  }
  bt_rows_sum<R>(t, rs);
#pragma unroll
  for (int j = 0; j < R; ++j) rs[j] = rsqrtf(rs[j] / C + 1e-6f);
}

// The same for one row of any width, by loops over x's row xr (the wide C
// route: x read from device memory once, then from L1): (mean, rs).
__device__ __forceinline__ float2 lm_row_stats(const float* __restrict__ xr, int C) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mean = gmt_warp_sum(s) / C;
  s = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mean;
    s += d * d;
  }
  return make_float2(mean, rsqrtf(gmt_warp_sum(s) / C + 1e-6f));
}

// Rows k0 .. k0 + LM_KC - 1 and columns n0 .. n0 + LM_COLS - 1 of w (C, N)
// into a stage (zero past C and past the slice's cw columns): 16-byte
// cp.async where VEC (the caller commits), else plain loads.
template <bool VEC>
__device__ __forceinline__ void lm_load_stage(__nv_bfloat16* st, const __nv_bfloat16* __restrict__ w,
                                              int N, int C, int k0, int n0, int cw) {
  constexpr int CH = LM_COLS / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < LM_KC * CH; i += LM_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const __nv_bfloat16* src = w + (size_t)(k0 + r) * N + n0 + c;
    __nv_bfloat16* dst = st + r * LM_WLD + c;
    if (VEC) {
      const bool ok = k0 + r < C && c < cw;
      gmt_cp_async16(dst, ok ? src : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = k0 + r < C && c + e < cw ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// out[r, n] = bf16(LN(x[r]) * scale + bias) . bf16(w[:, n]) + b[n] for N >= 8;
// x (B, C) f32, w (C, N) bf16. Grid (N / LM_COLS, B / LM_ROWS), rounded up.
template <bool VEC, int VPL>
__global__ void __launch_bounds__(LM_THREADS) ln_matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int B, int C, int N) {
  constexpr int R = LM_ROWS / LM_WARPS, MT = LM_ROWS / 16, KS = LM_KC / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * LM_COLS, m0 = blockIdx.y * LM_ROWS;
  const int cw = min(LM_COLS, N - n0);
  const int nk = (C + LM_KC - 1) / LM_KC, ring = min(nk, LM_STAGES);
  const int Cp = (C + 15) / 16 * 16, ldh = Cp + 8;
  // shared memory: `ring` weight stages, then the strip's bf16 rows
  extern __shared__ __align__(16) unsigned char lm_smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(lm_smem);
  __nv_bfloat16* hs = stages + ring * LM_STAGE;
  // this lane's two output columns and their b, read now so that no load
  // waits behind the barriers
  const int col = n0 + warp * 8 + 2 * (lane % 4);
  const float b0 = col < N ? b[col] : 0.f, b1 = col + 1 < N ? b[col + 1] : 0.f;

  // the weight's first stages (all of them where nk <= LM_STAGES) fly
  // while LN runs; stage s is cp.async group s
#pragma unroll
  for (int s = 0; s < LM_STAGES; ++s) {
    if (s < nk) lm_load_stage<VEC>(stages + s * LM_STAGE, w, N, C, s * LM_KC, n0, cw);
    gmt_cp_async_commit();
  }

  // LN of this warp's R rows into hs as bf16, zero past C (up to Cp) and
  // on rows past B
  const int r0 = warp * R;
  if constexpr (VPL > 0) {
    constexpr int W = VEC ? 4 : 1;
    float v[R][VPL], mean[R], rs[R];
    lm_rows_stats<VEC, VPL, R>(x, m0 + r0, B, C, v, mean, rs);
#pragma unroll
    for (int i = 0; i < VPL; i += W) {
      const int c = lm_col<W>(i);
      if (c >= Cp) continue;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float o[W];
#pragma unroll
        for (int e = 0; e < W; ++e)
          o[e] = m0 + r0 + j < B && c + e < C
                     ? (v[j][i + e] - mean[j]) * rs[j] * scale[c + e] + bias[c + e]
                     : 0.f;
        __nv_bfloat16* dst = hs + (r0 + j) * ldh + c;
        if constexpr (VEC)
          *reinterpret_cast<uint2*>(dst) = make_uint2(gmt_pack_bf16(o[0], o[1]),
                                                      gmt_pack_bf16(o[2], o[3]));
        else
          dst[0] = __float2bfloat16(o[0]);
      }
    }
  } else {
    for (int j = 0; j < R; ++j) {
      const int m = m0 + r0 + j;
      const float* xr = x + (size_t)m * C;
      const float2 st = m < B ? lm_row_stats(xr, C) : make_float2(0.f, 0.f);
      for (int c = lane; c < Cp; c += 32)
        hs[(r0 + j) * ldh + c] = __float2bfloat16(
            m < B && c < C ? (xr[c] - st.x) * st.y * scale[c] + bias[c] : 0.f);
    }
  }

  // two sums a fragment, of the even and the odd k steps, so that the
  // products form two dependent chains of half the length
  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    // stage t has landed (groups past it may fly), and for t > 0 every warp
    // is past stage t - 1, whose slot the next copies refill; where every
    // stage is resident, one wait and one barrier serve them all
    if (nk <= LM_STAGES) {
      if (t == 0) {
        gmt_cp_async_wait<0>();
        __syncthreads();
      }
    } else {
      if (t == 0)
        gmt_cp_async_wait<LM_STAGES - 1>();
      else
        gmt_cp_async_wait<LM_STAGES - 2>();
      __syncthreads();
    }
    if (t > 0 && nk > LM_STAGES) {
      const int nt = t - 1 + LM_STAGES;
      if (nt < nk)
        lm_load_stage<VEC>(stages + ((t - 1) % LM_STAGES) * LM_STAGE, w, N, C, nt * LM_KC, n0, cw);
      gmt_cp_async_commit();
    }
    if (warp * 8 >= cw) continue;  // a group past N: the warp keeps the barriers only
    const __nv_bfloat16* st = stages + (t % LM_STAGES) * LM_STAGE + warp * 8;
    const int ka0 = t * LM_KC, ksteps = min(KS, (C - ka0 + 15) / 16);
    unsigned bf[KS / 2][4];  // bf[i]: (b0, b1) of k-steps 2i and 2i + 1
#pragma unroll
    for (int ks = 0; ks < KS; ks += 2) gmt_ldmatrix_x4_trans(bf[ks / 2], st + (ks * 16 + lane) * LM_WLD);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned af[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) break;
        gmt_ldmatrix_x4(af[ks], hs + (mt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ldh + ka0 +
                                    ks * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= ksteps) break;
        gmt_mma_bf16(acc[ks % 2][mt], af[ks], bf[ks / 2][2 * (ks % 2)],
                     bf[ks / 2][2 * (ks % 2) + 1]);
      }
    }
  }

  // rows g and g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + lane / 4 + 8 * h;
      if (m >= B || col >= N) continue;
      float* dst = out + (size_t)m * N + col;
      const float v0 = (acc[0][mt][2 * h] + acc[1][mt][2 * h]) + b0;
      const float v1 = (acc[0][mt][2 * h + 1] + acc[1][mt][2 * h + 1]) + b1;
      if (VEC) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < N) dst[1] = v1;
      }
    }
}

// out[r, n] as above for N < 8: a warp a row, the products on the CUDA
// cores. Grid B / LM_DOT_WARPS, rounded up.
template <int VPL>
__global__ void __launch_bounds__(32 * LM_DOT_WARPS) ln_matmul_dot_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int B, int C, int N) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * LM_DOT_WARPS + threadIdx.x / 32;
  if (m >= B) return;
  float acc[LM_DOT_MAX_N];
#pragma unroll
  for (int n = 0; n < LM_DOT_MAX_N; ++n) acc[n] = 0.f;
  auto dot = [&](int c, float h) {  // h = the row's LN at column c, as bf16
#pragma unroll
    for (int n = 0; n < LM_DOT_MAX_N; ++n)
      if (n < N) acc[n] = fmaf(h, __bfloat162float(w[(size_t)c * N + n]), acc[n]);
  };
  if constexpr (VPL > 0) {
    float v[1][VPL], mean[1], rs[1];
    lm_rows_stats<false, VPL, 1>(x, m, B, C, v, mean, rs);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lm_col<1>(i);
      if (c < C) dot(c, gmt_round_bf16((v[0][i] - mean[0]) * rs[0] * scale[c] + bias[c]));
    }
  } else {
    const float* xr = x + (size_t)m * C;
    const float2 st = lm_row_stats(xr, C);
    for (int c = lane; c < C; c += 32)
      dot(c, gmt_round_bf16((xr[c] - st.x) * st.y * scale[c] + bias[c]));
  }
#pragma unroll
  for (int n = 0; n < LM_DOT_MAX_N; ++n)
    if (n < N) {
      const float s = gmt_warp_sum(acc[n]);
      if (lane == 0) out[(size_t)m * N + n] = s + b[n];
    }
}

// ---------------------------------------------------------------- Kernel B

constexpr int BT_ROWS = 16;                  // rows a cluster (one m16 tile)
constexpr int BT_CONSUMERS = 256;            // 8 warps: an 8-column group of each chunk each
constexpr int BT_THREADS = BT_CONSUMERS + 32;  // and one producer warp
constexpr int BT_KC = 64, BT_NC = 64;        // a weight tile: BT_KC rows x BT_NC columns
constexpr int BT_WLD = BT_NC + 8;            // its row stride: ldmatrix rows on distinct banks
constexpr int BT_SLOT = BT_KC * BT_WLD;      // bf16 elements of a ring slot
constexpr int BT_MAX_SLOTS = 24, BT_MAX_C = 512, BT_MAX_CLUSTER = 16;
constexpr int BT_BARRIERS = 2 * BT_MAX_SLOTS * 8;  // bytes of the slots' mbarriers

// mbarriers (the ring's full and empty signals), the cluster barrier split
// into its arrive and wait halves, and the consumer warps' named barrier
__device__ __forceinline__ void bt_mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(gmt_smem_addr(b)), "r"(count));
}

__device__ __forceinline__ void bt_mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(gmt_smem_addr(b)) : "memory");
}

// arrive once this thread's cp.async copies so far have landed
__device__ __forceinline__ void bt_mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(gmt_smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void bt_mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(gmt_smem_addr(b)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bt_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bt_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bt_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(BT_CONSUMERS) : "memory");
}

// distributed shared memory: an 8-byte store to p's place (an address in
// this block's shared memory) in block `rank` of the cluster
__device__ __forceinline__ void bt_st_remote2(const void* p, int rank, float a, float b) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(gmt_smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(r), "f"(a), "f"(b) : "memory");
}

// n floats of src -> dst, zero from `valid` on, by the consumer threads:
// 16-byte cp.async where VEC (the caller commits and waits), else plain
// loads
template <bool VEC>
__device__ __forceinline__ void bt_stage_floats(float* dst, const float* __restrict__ src,
                                                int valid, int n) {
  for (int i = threadIdx.x * 4; i < n; i += BT_CONSUMERS * 4) {
    if (VEC) {
      gmt_cp_async16(dst + i, i < valid ? src + i : src, i < valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[i + e] = i + e < valid ? src[i + e] : 0.f;
    }
  }
}

// One stage's weight slice as this block streams it: rows row0 ..
// row0 + K - 1, columns c0 .. c0 + width - 1 of w (row stride ldw), cut
// into tiles column chunk by column chunk, K chunk by K chunk.
struct BtSlice {
  const __nv_bfloat16* w;
  int ldw, row0, c0, K, width, nk, ncc;
};

__device__ __forceinline__ BtSlice bt_slice(const __nv_bfloat16* w, int ldw, int row0, int c0,
                                            int K, int width) {
  return BtSlice{w, ldw, row0, c0, K, width, (K + BT_KC - 1) / BT_KC,
                 (width + BT_NC - 1) / BT_NC};
}

// block (p0, pw, f0, fw)'s slice of stage st: proj's C x pw columns of
// wproj, fc1's C x fw columns of wfc1, fc2's fw rows of wfc2
struct BtSlices {
  const __nv_bfloat16 *wproj, *wfc1, *wfc2;
  int C, p0, pw, f0, fw;
  __device__ __forceinline__ BtSlice operator()(int st) const {
    return st == 0 ? bt_slice(wproj, C, 0, p0, C, pw)
                   : st == 1 ? bt_slice(wfc1, 4 * C, 0, f0, C, fw) : bt_slice(wfc2, C, f0, 0, fw, C);
  }
};

// The producer warp: every tile of the block's proj, fc1 and fc2 slices in
// order, tile t into slot t % slots once its last readers have released it
// (empty), then full[slot] fires when the copies have landed. Zero past K
// and the slice's width; only the 8-column groups the products read.
template <bool VEC>
__device__ __forceinline__ void bt_produce(const BtSlices& sl, __nv_bfloat16* ring,
                                           uint64_t* full, uint64_t* empty, int slots) {
  const int lane = threadIdx.x % 32;
  int t = 0;
  for (int st = 0; st < 3; ++st) {
    const BtSlice s = sl(st);
    for (int cc = 0; cc < s.ncc; ++cc)
      for (int kc = 0; kc < s.nk; ++kc, ++t) {
        const int slot = t % slots;
        if (t >= slots) bt_mbar_wait(&empty[slot], (t / slots - 1) & 1);
        __nv_bfloat16* dst0 = ring + slot * BT_SLOT;
        const int k0 = kc * BT_KC, n0 = cc * BT_NC;
        const int krows = min(BT_KC, s.K - k0), cw = min(BT_NC, s.width - n0);
        const int chunks = (cw + 7) / 8;  // 16-byte chunks a row
        const __nv_bfloat16* src0 = s.w + (size_t)(s.row0 + k0) * s.ldw + s.c0 + n0;
        for (int i = lane; i < BT_KC * chunks; i += 32) {
          const int r = i / chunks, c = (i % chunks) * 8;
          __nv_bfloat16* dst = dst0 + r * BT_WLD + c;
          const __nv_bfloat16* src = src0 + (size_t)r * s.ldw + c;
          if (VEC) {
            gmt_cp_async16(dst, r < krows ? src : s.w, r < krows);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = r < krows && c + e < cw ? src[e] : __float2bfloat16(0.f);
          }
        }
        if (VEC)
          bt_mbar_arrive_cp_async(&full[slot]);
        else
          bt_mbar_arrive(&full[slot]);
      }
  }
}

// acc (the strip's 16 rows x this warp's 8-column group of the tile, one
// m16n8 fragment) += A's rows (bf16, row stride lda, columns ka0 ..) @ tile
// t, over ksteps 16-deep steps (warps past the tile's ngroups groups only
// keep the protocol), then the warp releases the slot. Every fragment of
// the tile is loaded before its products.
__device__ __forceinline__ void bt_tile_mma(float (&acc)[4], const __nv_bfloat16* A, int lda,
                                            int ka0, int ksteps, int ngroups,
                                            const __nv_bfloat16* ring, uint64_t* full,
                                            uint64_t* empty, int slots, int t) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = t % slots;
  bt_mbar_wait(&full[slot], (t / slots) & 1);
  if (warp < ngroups) {
    const __nv_bfloat16* s = ring + slot * BT_SLOT + warp * 8;
    constexpr int KS = BT_KC / 16;
    unsigned af[KS][4], bf[KS / 2][4];  // bf[i]: (b0, b1) of k-steps 2i and 2i + 1
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ksteps) break;
      gmt_ldmatrix_x4(af[ks], A + (lane % 8 + ((lane / 8) % 2) * 8) * lda + ka0 + ks * 16 +
                                  (lane / 16) * 8);
      if (ks % 2 == 0) gmt_ldmatrix_x4_trans(bf[ks / 2], s + (ks * 16 + lane) * BT_WLD);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ksteps) break;
      gmt_mma_bf16(acc, af[ks], bf[ks / 2][2 * (ks % 2)], bf[ks / 2][2 * (ks % 2) + 1]);
    }
  }
  __syncwarp();
  if (lane == 0) bt_mbar_arrive(&empty[slot]);
}

// LN2 of this warp's 2 rows of h1 (f32, row stride ldf, every block's
// columns), W columns a load (4 where VEC), VPL values a lane a row
// (C <= 32 VPL); two-pass mean and variance, eps 1e-6; scale s and bias b
// in shared memory; the bf16 result into g (row stride ldg).
template <bool VEC, int VPL>
__device__ __forceinline__ void bt_layernorm(const float* h1, int ldf, int C, const float* s,
                                             const float* b, __nv_bfloat16* g, int ldg) {
  constexpr int W = VEC ? 4 : 1, NV = VPL / W;  // columns a load, loads a lane a row
  constexpr int RB = BT_ROWS / (BT_CONSUMERS / 32);  // rows a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * RB;
  float v[RB][VPL];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (lane + 32 * i) * W;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float* src = h1 + (r0 + j) * ldf + c;
      if constexpr (VEC) {
        const float4 f = c < C ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[j][4 * i] = f.x, v[j][4 * i + 1] = f.y, v[j][4 * i + 2] = f.z, v[j][4 * i + 3] = f.w;
      } else {
        v[j][i] = c < C ? src[0] : 0.f;
      }
    }
  }
  float t[RB], mean[RB], rs[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    t[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) t[j] += v[j][i];
  }
  bt_rows_sum<RB>(t, mean);
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    mean[j] /= C;
    t[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float d = (lane + 32 * (i / W)) * W + i % W < C ? v[j][i] - mean[j] : 0.f;
      t[j] += d * d;
    }
  }
  bt_rows_sum<RB>(t, rs);
#pragma unroll
  for (int j = 0; j < RB; ++j) rs[j] = rsqrtf(rs[j] / C + 1e-6f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (lane + 32 * i) * W;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      float o[W];
#pragma unroll
      for (int e = 0; e < W; ++e) o[e] = (v[j][W * i + e] - mean[j]) * rs[j] * s[c + e] + b[c + e];
      __nv_bfloat16* dst = g + (r0 + j) * ldg + c;
      if constexpr (VEC)
        *reinterpret_cast<uint2*>(dst) = make_uint2(gmt_pack_bf16(o[0], o[1]),
                                                    gmt_pack_bf16(o[2], o[3]));
      else
        dst[0] = __float2bfloat16(o[0]);
    }
  }
}

// out = h1 + (bf16(gelu(bf16(LN2(h1)) . wfc1 + bfc1)) . wfc2 + bfc2),
// h1 = x + (bf16(y) . wproj + bproj); x, y (B, C) f32; wproj (C, C), wfc1
// (C, 4C), wfc2 (4C, C) bf16. Grid (n, B / 16), one cluster of n blocks a
// 16-row strip; P, F and slots as plan_block_tail lays them out.
template <bool VEC, int VPL>
__global__ void __launch_bounds__(BT_THREADS, 1) block_tail_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ ln2s, const float* __restrict__ ln2b,
    const __nv_bfloat16* __restrict__ wfc1, const float* __restrict__ bfc1,
    const __nv_bfloat16* __restrict__ wfc2, const float* __restrict__ bfc2,
    float* __restrict__ out, int B, int C, int P, int F, int slots) {
  const int n = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BT_ROWS;
  const int Cp = (C + 15) / 16 * 16, ldy = Cp + 8, ldh = F + 8;

  // shared memory: the slots' mbarriers; Y (bf16(y), then bf16(LN2(h1)));
  // HID; H1 (every block's columns of h1, f32); IN (fc2's partial sums of
  // this block's P columns from each rank); the vectors (bproj's, bfc1's
  // and bfc2's slices, ln2 scale and bias); the ring
  extern __shared__ __align__(16) unsigned char bt_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(bt_smem);
  uint64_t* empty = full + BT_MAX_SLOTS;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(bt_smem + BT_BARRIERS);
  __nv_bfloat16* hid = ys + BT_ROWS * ldy;
  float* h1 = reinterpret_cast<float*>(hid + BT_ROWS * ldh);
  float* in = h1 + BT_ROWS * Cp;
  float* bp_s = in + n * BT_ROWS * P;
  float* b1_s = bp_s + P;
  float* b2_s = b1_s + F;
  float* ls_s = b2_s + P;
  float* lb_s = ls_s + Cp;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(lb_s + Cp);

  const int p0 = rank * P, pw = max(0, min(P, C - p0));
  const int f0 = rank * F, fw = max(0, min(F, 4 * C - f0));
  const BtSlices sl{wproj, wfc1, wfc2, C, p0, pw, f0, fw};
  if (threadIdx.x == 0)
    for (int i = 0; i < slots; ++i) {
      bt_mbar_init(&full[i], 32);
      bt_mbar_init(&empty[i], BT_CONSUMERS / 32);
    }
  __syncthreads();
  // cluster barrier 0: every block has started before any writes into
  // another's shared memory (the consumers wait for it just before their
  // first remote store)
  bt_cluster_arrive();

  if (warp == BT_CONSUMERS / 32) {
    // the producer writes nothing another block reads: it arrives at
    // barrier 1 at once, so that the consumers never wait for it there
    // while it waits for them to free a slot
    bt_cluster_wait();
    bt_cluster_arrive();
    bt_produce<VEC>(sl, ring, full, empty, slots);
    bt_cluster_wait();
    bt_cluster_arrive();  // barrier 2, the partials'
    bt_cluster_wait();
    return;
  }

  // x's slice into h1's own columns (zero past B and pw) and the vectors,
  // by cp.async where VEC, while bf16(y)'s rows (zero past B and C) load
  for (int i = threadIdx.x; i < BT_ROWS * (P / 4); i += BT_CONSUMERS) {
    const int r = i / (P / 4), c = (i % (P / 4)) * 4, m = m0 + r;
    const float* src = x + (size_t)m * C + p0 + c;
    float* dst = h1 + r * Cp + p0 + c;
    if (p0 + c >= Cp) continue;
    if (VEC) {
      const bool ok = m < B && c < pw;
      gmt_cp_async16(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = m < B && c + e < pw ? src[e] : 0.f;
    }
  }
  bt_stage_floats<VEC>(bp_s, bproj + p0, pw, P);
  bt_stage_floats<VEC>(b1_s, bfc1 + f0, fw, F);
  bt_stage_floats<VEC>(b2_s, bfc2 + p0, pw, P);
  bt_stage_floats<VEC>(ls_s, ln2s, C, Cp);
  bt_stage_floats<VEC>(lb_s, ln2b, C, Cp);
  if (VEC) gmt_cp_async_commit();
  constexpr int YB = 8;  // float4 a thread in flight
  const int y4 = BT_ROWS * Cp / 4;
  for (int base4 = 0; base4 < y4; base4 += YB * BT_CONSUMERS) {
    float v[YB][4];
#pragma unroll
    for (int j = 0; j < YB; ++j) {
      const int i = base4 + threadIdx.x + j * BT_CONSUMERS;
      const int r = i / (Cp / 4), c = (i % (Cp / 4)) * 4, m = m0 + r;
      const float* yr = y + (size_t)m * C + c;
      if (VEC) {
        const float4 f = i < y4 && m < B ? *reinterpret_cast<const float4*>(yr)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        v[j][0] = f.x, v[j][1] = f.y, v[j][2] = f.z, v[j][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = i < y4 && m < B && c + e < C ? yr[e] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < YB; ++j) {
      const int i = base4 + threadIdx.x + j * BT_CONSUMERS;
      const int r = i / (Cp / 4), c = (i % (Cp / 4)) * 4;
      if (i < y4)
        *reinterpret_cast<uint2*>(ys + r * ldy + c) =
            make_uint2(gmt_pack_bf16(v[j][0], v[j][1]), gmt_pack_bf16(v[j][2], v[j][3]));
    }
  }
  if (VEC) gmt_cp_async_wait<0>();
  bt_consumers_sync();  // y, x's slice and the vectors are in

  const int g = lane / 4, c2 = 2 * (lane % 4);
  float acc[4];
  int t = 0;
  // the three products in one loop, so that their code is emitted once:
  //   proj  h1[:, p0 + c] = x + (bf16(y) . wproj[:, p0 + c] + bproj), into
  //         every block's H1
  //   fc1   hid[:, c] = bf16(gelu(g . wfc1[:, f0 + c] + bfc1)), zero past fw
  //   fc2   hid . wfc2[f0 .. f0 + fw, :] (zero where fw is 0), column c into
  //         IN[rank] of block c / P
  for (int st = 0; st < 3; ++st) {
    const BtSlice s = sl(st);
    for (int cc = 0; cc < s.ncc; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = 0.f;
      const int ngroups = (min(BT_NC, s.width - cc * BT_NC) + 7) / 8;
      for (int kc = 0; kc < s.nk; ++kc)
        bt_tile_mma(acc, st == 2 ? hid : ys, st == 2 ? ldh : ldy, kc * BT_KC,
                    (min(BT_KC, s.K - kc * BT_KC) + 15) / 16, ngroups, ring, full, empty, slots,
                    t++);
      const int c = cc * BT_NC + warp * 8 + c2;  // this lane's two columns, rows g and g + 8
      if (st == 0 && cc == 0) bt_cluster_wait();  // barrier 0: every block has started
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        const float a0 = acc[2 * h], a1 = acc[2 * h + 1];
        if (st == 0) {
          if (c < pw) {
            const float* hp = h1 + r * Cp + p0 + c;
            const float v0 = hp[0] + (a0 + bp_s[c]), v1 = hp[1] + (a1 + bp_s[c + 1]);
            for (int q = 0; q < n; ++q) bt_st_remote2(hp, q, v0, v1);
          }
        } else if (st == 1) {
          if (c < F)
            *reinterpret_cast<unsigned*>(hid + r * ldh + c) =
                gmt_pack_bf16(c < fw ? gelu_tanh(a0 + b1_s[c]) : 0.f,
                              c + 1 < fw ? gelu_tanh(a1 + b1_s[c + 1]) : 0.f);
        } else if (c < C) {
          bt_st_remote2(in + (rank * BT_ROWS + r) * P + c % P, c / P, a0, a1);
        }
      }
    }
    if (st == 0) {
      if (s.ncc == 0) bt_cluster_wait();  // barrier 0, where proj had no columns here
      bt_cluster_arrive();  // barrier 1: every block's columns of h1 are in every H1
      bt_cluster_wait();
      bt_layernorm<VEC, VPL>(h1, Cp, C, ls_s, lb_s, ys, ldy);
    }
    bt_consumers_sync();  // g (fc1's operand) complete; then hid (fc2's)
  }
  bt_cluster_arrive();  // barrier 2: every block's partials are in its owner's IN
  bt_cluster_wait();

  // this block's columns: the ranks' partials summed in rank order,
  // + bfc2 + h1; nothing remote is read, so no block waits for another
  for (int i = threadIdx.x; i < BT_ROWS * pw; i += BT_CONSUMERS) {
    const int r = i / pw, c = i % pw, m = m0 + r;
    if (m >= B) continue;
    float sum = in[r * P + c];
    for (int q = 1; q < n; ++q) sum += in[(q * BT_ROWS + r) * P + c];
    out[(size_t)m * C + p0 + c] = h1[r * Cp + p0 + c] + (sum + b2_s[c]);
  }
}

template <bool VEC, int VPL>
static cudaError_t lm_launch(const float* x, const float* scale, const float* bias,
                             const __nv_bfloat16* w, const float* b, float* out, int B, int C,
                             int N, size_t smem, cudaStream_t stream) {
  const cudaError_t e = gmt_allow_smem(ln_matmul_kernel<VEC, VPL>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + LM_COLS - 1) / LM_COLS, (B + LM_ROWS - 1) / LM_ROWS);
  ln_matmul_kernel<VEC, VPL><<<grid, LM_THREADS, smem, stream>>>(x, scale, bias, w, b, out, B, C,
                                                                N);
  return cudaGetLastError();
}

// A: out (B, N) f32 = LN(x) . w + b, by the route plan_ln_matmul names:
// the dot route for N < 8, else the tensor cores, 16-byte loads where VEC.
// Refuses C past 6096, where the rows and the stages outgrow a block.
extern "C" int gmt_ln_matmul(const float* x, const float* scale, const float* bias,
                             const __nv_bfloat16* w, const float* b, float* out,
                             int B, int C, int N, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  const int vpl = C <= 128 ? 4 : C <= 256 ? 8 : 0;  // x in registers up to C = 256
  if (N <= LM_DOT_MAX_N) {
    const int grid = (B + LM_DOT_WARPS - 1) / LM_DOT_WARPS;
    auto kernel = vpl == 4 ? ln_matmul_dot_kernel<4>
                           : vpl == 8 ? ln_matmul_dot_kernel<8> : ln_matmul_dot_kernel<0>;
    kernel<<<grid, 32 * LM_DOT_WARPS, 0, stream>>>(x, scale, bias, w, b, out, B, C, N);
    return cudaGetLastError();
  }
  const size_t nk = (C + LM_KC - 1) / LM_KC, cp = (C + 15) / 16 * 16;
  const size_t smem = (nk < LM_STAGES ? nk : LM_STAGES) * LM_STAGE * 2 + LM_ROWS * (cp + 8) * 2;
  if (smem > SMEM_MAX || (B + LM_ROWS - 1) / LM_ROWS > 65535) return cudaErrorInvalidValue;
  const bool vec = N % 8 == 0 && C % 4 == 0 && gmt_aligned16(x) && gmt_aligned16(w);
#define LM_ARGS x, scale, bias, w, b, out, B, C, N, smem, stream
  if (vec)
    return vpl == 4 ? lm_launch<true, 4>(LM_ARGS)
                    : vpl == 8 ? lm_launch<true, 8>(LM_ARGS) : lm_launch<true, 0>(LM_ARGS);
  return vpl == 4 ? lm_launch<false, 4>(LM_ARGS)
                  : vpl == 8 ? lm_launch<false, 8>(LM_ARGS) : lm_launch<false, 0>(LM_ARGS);
#undef LM_ARGS
}

template <bool VEC, int VPL>
static cudaError_t bt_launch(const float* x, const float* y, const __nv_bfloat16* wproj,
                             const float* bproj, const float* ln2s, const float* ln2b,
                             const __nv_bfloat16* wfc1, const float* bfc1,
                             const __nv_bfloat16* wfc2, const float* bfc2, float* out, int B,
                             int C, int n, int P, int F, int slots, size_t smem,
                             cudaStream_t stream) {
  auto kernel = block_tail_kernel<VEC, VPL>;
  // the attributes once a process (a decode loop launches B thousands of
  // times): the largest shared memory asked for so far, then clusters past 8
  static size_t smem_set = 0;
  static bool wide_set = false;
  cudaError_t e = cudaSuccess;
  if (smem > smem_set && (e = gmt_allow_smem(kernel, smem)) == cudaSuccess) smem_set = smem;
  if (e == cudaSuccess && n > 8 && !wide_set &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) ==
          cudaSuccess)
    wide_set = true;
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, (B + BT_ROWS - 1) / BT_ROWS);
  cfg.blockDim = dim3(BT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, y, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
                         out, B, C, P, F, slots);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// B: the post-attention half of a decode step over clusters of n blocks
// a 16-row strip, slices of P and F columns, a ring of `slots` weight tiles
// (plan_block_tail in ops/decode_fused.py). Refuses a plan that leaves a
// column unowned or does not fit: 1 <= C <= 512, 1 <= n <= 16, P and F
// whole 16-column groups with n P >= C and n F >= 4C, 2 <= slots <= 24,
// the shared memory within the card's.
extern "C" int gmt_block_tail(const float* x, const float* y, const __nv_bfloat16* wproj,
                              const float* bproj, const float* ln2s, const float* ln2b,
                              const __nv_bfloat16* wfc1, const float* bfc1,
                              const __nv_bfloat16* wfc2, const float* bfc2, float* out,
                              int B, int C, int n, int P, int F, int slots,
                              cudaStream_t stream) {
  if (B <= 0 || C < 1 || C > BT_MAX_C || n < 1 || n > BT_MAX_CLUSTER || P < 16 || P % 16 ||
      F < 16 || F % 16 || (long)n * P < C || (long)n * F < 4L * C || slots < 2 || slots > BT_MAX_SLOTS || (B + BT_ROWS - 1) / BT_ROWS > 65535)
    return cudaErrorInvalidValue;
  const size_t cp = (C + 15) / 16 * 16;
  const size_t smem = BT_BARRIERS + (size_t)BT_ROWS * (cp + 8) * 2 +
                      (size_t)BT_ROWS * (F + 8) * 2 + (size_t)BT_ROWS * cp * 4 +
                      (size_t)n * BT_ROWS * P * 4 + (2 * (size_t)P + F + 2 * cp) * 4 +
                      (size_t)slots * BT_SLOT * 2;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 && gmt_aligned16(x) && gmt_aligned16(y) && gmt_aligned16(wproj) &&
                   gmt_aligned16(bproj) && gmt_aligned16(ln2s) && gmt_aligned16(ln2b) &&
                   gmt_aligned16(wfc1) && gmt_aligned16(bfc1) && gmt_aligned16(wfc2) &&
                   gmt_aligned16(bfc2) && gmt_aligned16(out);
#define BT_ARGS                                                                                   \
  x, y, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, out, B, C, n, P, F, slots, smem, \
      stream
  if (vec)
    return C <= 128   ? bt_launch<true, 4>(BT_ARGS)
           : C <= 256 ? bt_launch<true, 8>(BT_ARGS)
                      : bt_launch<true, 16>(BT_ARGS);
  return C <= 128   ? bt_launch<false, 4>(BT_ARGS)
         : C <= 256 ? bt_launch<false, 8>(BT_ARGS)
                    : bt_launch<false, 16>(BT_ARGS);
#undef BT_ARGS
}
