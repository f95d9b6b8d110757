// Kernels A (ln_matmul) and B (block_tail): the dense halves of one
// KV-cached transformer decode step, for sm_90a.
//
// Replaces: generative_models_tpu/ops/decode_fused.py _ln_matmul_kernel (:46,
// called by ln_matmul :55) and _block_tail_kernel (:71, called by block_tail
// :95).
//
// What bounds them on an H100: nothing the card is short of. At the serving
// shape (B=64 rows, C=128) one launch moves under 1 MB (the bf16 weights are
// most of it, and they stay in the 50 MB L2 across decode steps) and does
// under 20 MFLOP, so a launch costs its fixed latency: the launch itself and
// the longest chain of dependent loads and FMAs in one thread. The design
// keeps that chain short and puts nothing in device memory between the
// fused ops:
//   * one block owns a tile of rows and does every stage for it, so the
//     normalised rows (A) and h1 plus the 4C-wide hidden row (B) live in
//     shared memory only; only the (B, N) result is written;
//   * threads map to output columns, so each weight row is read coalesced,
//     and each loaded weight feeds one FMA per row of the tile (the rows are
//     a broadcast read from shared memory);
//   * where a stage has fewer output columns than threads (the head's N = 1,
//     B's out-proj and fc2 with N = C), the threads split the reduction and
//     meet in shared memory, so no thread walks more than its share of K;
//     the reduction loops are unrolled so the weight loads overlap;
//   * operands are rounded to bf16 and products accumulate in f32, the JAX
//     package's numerics on an accelerator, with plain FMA loops: at 64 rows
//     the tensor cores would idle on the same latency chain.
// The ragged edges (rows past B, columns past N) are masked in the kernel.

#include "common.cuh"

constexpr int LM_ROWS = 8;       // rows of x per ln_matmul block
constexpr int LM_COLS = 32;      // output columns per ln_matmul block
constexpr int LM_THREADS = 128;
constexpr int BT_ROWS = 4;       // rows per block_tail block
constexpr int BT_THREADS = 512;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block can have

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu's default (tanh) approximation
  const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
  return v * cdf;
}

// dst[r * ncols + j] = sum_k src[r * K + k] * W[k * ldw + n0 + j] for r < ROWS,
// j < ncols. When ncols < blockDim.x the threads split K into blockDim.x /
// ncols slices whose partial sums meet in scratch (ROWS * max(blockDim.x,
// ncols) floats), summed in slice order. Ends with a __syncthreads().
template <int ROWS>
__device__ void rows_matmul(const float* src, int K, const __nv_bfloat16* __restrict__ W,
                            int ldw, int n0, int ncols, float* scratch, float* dst) {
  const int splits = max(1, (int)blockDim.x / ncols);
  const int span = (K + splits - 1) / splits;
  for (int idx = threadIdx.x; idx < ncols * splits; idx += blockDim.x) {
    const int j = idx % ncols, part = idx / ncols;
    const int k1 = min(K, (part + 1) * span);
    const __nv_bfloat16* wj = W + n0 + j;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int k = part * span; k < k1; ++k) {
      const float wv = __bfloat162float(wj[(size_t)k * ldw]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(src[r * K + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) scratch[(part * ROWS + r) * ncols + j] = acc[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * ncols; i += blockDim.x) {
    float s = 0.f;
    for (int part = 0; part < splits; ++part) s += scratch[part * ROWS * ncols + i];
    dst[i] = s;
  }
  __syncthreads();
}

// out[r, n] = LN(x[r]) . w[:, n] + b[n]; x (B, C) f32, w (C, N) bf16.
__global__ void __launch_bounds__(LM_THREADS) ln_matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int B, int C, int N) {
  extern __shared__ float sm[];
  float* h = sm;                         // (LM_ROWS, C) normalised rows, bf16-rounded
  float* acc = h + LM_ROWS * C;          // (LM_ROWS, LM_COLS) products
  float* scratch = acc + LM_ROWS * LM_COLS;  // (LM_ROWS, LM_THREADS) partial sums
  const int r0 = blockIdx.x * LM_ROWS, n0 = blockIdx.y * LM_COLS;
  const int ncols = min(LM_COLS, N - n0);
  gmt_layernorm_rows_bf16(x + (size_t)r0 * C, scale, bias, h, LM_ROWS, B - r0, C);
  __syncthreads();
  rows_matmul<LM_ROWS>(h, C, w, N, n0, ncols, scratch, acc);
  for (int i = threadIdx.x; i < LM_ROWS * ncols; i += LM_THREADS) {
    const int r = i / ncols, j = i % ncols;
    if (r0 + r < B) out[(size_t)(r0 + r) * N + n0 + j] = acc[i] + b[n0 + j];
  }
}

// out = h1 + (gelu(LN2(h1) . wfc1 + bfc1) . wfc2 + bfc2), h1 = x + (y . wproj
// + bproj); x, y (B, C) f32; wproj (C, C), wfc1 (C, 4C), wfc2 (4C, C) bf16.
__global__ void __launch_bounds__(BT_THREADS) block_tail_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ ln2s, const float* __restrict__ ln2b,
    const __nv_bfloat16* __restrict__ wfc1, const float* __restrict__ bfc1,
    const __nv_bfloat16* __restrict__ wfc2, const float* __restrict__ bfc2,
    float* __restrict__ out, int B, int C) {
  extern __shared__ float sm[];
  const int H4 = 4 * C;
  float* ys = sm;                  // (BT_ROWS, C) attention output, bf16-rounded
  float* h1 = ys + BT_ROWS * C;    // (BT_ROWS, C) first residual sum
  float* g = h1 + BT_ROWS * C;     // (BT_ROWS, C) LN2(h1), bf16-rounded
  float* hid = g + BT_ROWS * C;    // (BT_ROWS, 4C) fc1, then gelu(fc1) bf16-rounded
  float* acc = hid + BT_ROWS * H4;  // (BT_ROWS, C) products of proj and fc2
  float* scratch = acc + BT_ROWS * C;  // partial sums, BT_ROWS * max(BT_THREADS, 4C)
  const int r0 = blockIdx.x * BT_ROWS;
  const int valid = min(BT_ROWS, B - r0);

  for (int i = threadIdx.x; i < BT_ROWS * C; i += BT_THREADS)
    ys[i] = i / C < valid ? gmt_round_bf16(y[(size_t)r0 * C + i]) : 0.f;
  __syncthreads();

  rows_matmul<BT_ROWS>(ys, C, wproj, C, 0, C, scratch, acc);
  for (int i = threadIdx.x; i < BT_ROWS * C; i += BT_THREADS)
    h1[i] = i / C < valid ? x[(size_t)r0 * C + i] + (acc[i] + bproj[i % C]) : 0.f;
  __syncthreads();

  gmt_layernorm_rows_bf16(h1, ln2s, ln2b, g, BT_ROWS, valid, C);
  __syncthreads();

  rows_matmul<BT_ROWS>(g, C, wfc1, H4, 0, H4, scratch, hid);
  for (int i = threadIdx.x; i < BT_ROWS * H4; i += BT_THREADS)
    hid[i] = gmt_round_bf16(gelu_tanh(hid[i] + bfc1[i % H4]));
  __syncthreads();

  rows_matmul<BT_ROWS>(hid, H4, wfc2, C, 0, C, scratch, acc);
  for (int i = threadIdx.x; i < valid * C; i += BT_THREADS)
    out[(size_t)r0 * C + i] = h1[i] + (acc[i] + bfc2[i % C]);
}

extern "C" int gmt_ln_matmul(const float* x, const float* scale, const float* bias,
                             const __nv_bfloat16* w, const float* b, float* out,
                             int B, int C, int N, cudaStream_t stream) {
  const size_t smem = (size_t)LM_ROWS * (C + LM_COLS + LM_THREADS) * sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;  // C too wide for one block
  cudaError_t e = gmt_allow_smem(ln_matmul_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + LM_ROWS - 1) / LM_ROWS, (N + LM_COLS - 1) / LM_COLS);
  ln_matmul_kernel<<<grid, LM_THREADS, smem, stream>>>(x, scale, bias, w, b, out, B, C, N);
  return cudaGetLastError();
}

extern "C" int gmt_block_tail(const float* x, const float* y, const __nv_bfloat16* wproj,
                              const float* bproj, const float* ln2s, const float* ln2b,
                              const __nv_bfloat16* wfc1, const float* bfc1,
                              const __nv_bfloat16* wfc2, const float* bfc2, float* out,
                              int B, int C, cudaStream_t stream) {
  const size_t smem = (size_t)BT_ROWS * (8 * C + (BT_THREADS > 4 * C ? BT_THREADS : 4 * C)) * sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;  // C too wide for one block
  cudaError_t e = gmt_allow_smem(block_tail_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + BT_ROWS - 1) / BT_ROWS);
  block_tail_kernel<<<grid, BT_THREADS, smem, stream>>>(
      x, y, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2, out, B, C);
  return cudaGetLastError();
}
