// Kernel F (vq_one_hot): the VQ-VAE codebook search, for sm_90a. For each
// row of z (N, D) f32, the nearest code of the codebook e (K, D) f32 by
// argmin over k of -2 z.e_k + |e_k|^2 (|z|^2 is the same for every k), with
// the first index on ties, written as a one-hot (N, K) f32 row and as the
// int32 index.
//
// Replaces: generative_models_tpu/ops/quantize.py _vq_kernel (:23, called by
// vq_one_hot :56). The TPU kernel holds the whole padded codebook in VMEM
// and gives up on XLA past a VMEM budget (quantize.py:80-86); this one
// streams the codebook through shared memory in K-tiles, so it takes any N,
// K and D, and has no such gate.
//
// What bounds it on an H100: bytes. At the training shape (N=3136, K=D=64)
// it reads 0.82 MB of z and codebook and writes the 0.80 MB one-hot, and does
// 26 MFLOP: 0.48 us at 3.35 TB/s against 0.39 us of f32 FMA at 67 TFLOP/s.
// At that size a launch costs its fixed latency; the design keeps the (N, K)
// score matrix out of device memory (only the one-hot the API returns is
// written) and writes that one-hot coalesced:
//   * one block owns ROWS rows of z; a 16 x 16 thread grid gives each thread
//     RI rows x CJ codes of every K-tile, so each shared-memory load feeds
//     RI or CJ FMAs;
//   * the codebook streams through shared memory in KT-code tiles and D in
//     DC-wide chunks (z's chunk is re-read per K-tile, from L1/L2), with
//     each code's |e|^2 summed from the same tile;
//   * the score is plain f32 FMA, as the TPU kernel's f32 product: rounding
//     the operands to bf16 would flip assignments against the reference;
//   * each thread keeps, per row, a running (best score, index) over the
//     codes it visits in ascending order, replacing only on a strict <; the
//     16 threads of a row meet by warp shuffles, a tie going to the lower
//     index, so the first index wins as in torch.argmin / jnp.argmin;
//   * the one-hot is written row-major by consecutive threads (coalesced),
//     from the block's indices in shared memory.
// Rows past N and codes past K are masked in the kernel; nothing is padded.

#include "common.cuh"

#include <climits>

constexpr int VQ_TX = 16;               // threads along codes
constexpr int VQ_TY = 16;               // threads along rows
constexpr int VQ_RI = 2;                // rows per thread
constexpr int VQ_CJ = 4;                // codes per thread per K-tile
constexpr int VQ_ROWS = VQ_TY * VQ_RI;  // 32 rows of z per block
constexpr int VQ_KT = VQ_TX * VQ_CJ;    // 64 codes per K-tile
constexpr int VQ_DC = 32;               // D-chunk held in shared memory
constexpr int VQ_THREADS = VQ_TX * VQ_TY;

// (s, i) beats (best, bi): a lower score, or the same score at a lower index
__device__ __forceinline__ bool vq_better(float s, int i, float best, int bi) {
  return s < best || (s == best && i < bi);
}

__global__ void __launch_bounds__(VQ_THREADS) vq_one_hot_kernel(
    const float* __restrict__ z, const float* __restrict__ e,
    float* __restrict__ one_hot, int* __restrict__ idx_out, int N, int K, int D) {
  __shared__ float zs[VQ_DC][VQ_ROWS + 1];  // z chunk, transposed (d, row)
  __shared__ float es[VQ_DC][VQ_KT + 1];    // codebook chunk, transposed (d, code)
  __shared__ float en[VQ_KT];               // |e_k|^2 of the tile's codes
  __shared__ int best_idx[VQ_ROWS];

  const int tid = threadIdx.x;
  const int tx = tid % VQ_TX, ty = tid / VQ_TX;
  const int r0 = blockIdx.x * VQ_ROWS;

  float best[VQ_RI];
  int bi[VQ_RI];
#pragma unroll
  for (int i = 0; i < VQ_RI; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    bi[i] = INT_MAX;
  }

  for (int k0 = 0; k0 < K; k0 += VQ_KT) {
    float acc[VQ_RI][VQ_CJ];
#pragma unroll
    for (int i = 0; i < VQ_RI; ++i)
#pragma unroll
      for (int j = 0; j < VQ_CJ; ++j) acc[i][j] = 0.f;
    float norm = 0.f;  // |e|^2 of code k0 + tid, summed by thread tid < KT

    for (int d0 = 0; d0 < D; d0 += VQ_DC) {
      const int dc = min(VQ_DC, D - d0);
      // consecutive threads read consecutive d of one row: coalesced
      for (int i = tid; i < VQ_ROWS * VQ_DC; i += VQ_THREADS) {
        const int r = i / VQ_DC, d = i % VQ_DC;
        zs[d][r] = (r0 + r < N && d < dc) ? z[(size_t)(r0 + r) * D + d0 + d] : 0.f;
      }
      for (int i = tid; i < VQ_KT * VQ_DC; i += VQ_THREADS) {
        const int c = i / VQ_DC, d = i % VQ_DC;
        es[d][c] = (k0 + c < K && d < dc) ? e[(size_t)(k0 + c) * D + d0 + d] : 0.f;
      }
      __syncthreads();
      if (tid < VQ_KT) {
        for (int d = 0; d < dc; ++d) norm = fmaf(es[d][tid], es[d][tid], norm);
      }
#pragma unroll 8
      for (int d = 0; d < dc; ++d) {
        float a[VQ_RI], b[VQ_CJ];
#pragma unroll
        for (int i = 0; i < VQ_RI; ++i) a[i] = zs[d][ty + VQ_TY * i];
#pragma unroll
        for (int j = 0; j < VQ_CJ; ++j) b[j] = es[d][tx + VQ_TX * j];
#pragma unroll
        for (int i = 0; i < VQ_RI; ++i)
#pragma unroll
          for (int j = 0; j < VQ_CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < VQ_KT) en[tid] = norm;
    __syncthreads();

    // this thread's codes in ascending order: a strict < keeps the first
#pragma unroll
    for (int j = 0; j < VQ_CJ; ++j) {
      const int c = tx + VQ_TX * j;
      if (k0 + c >= K) continue;
      const float ec = en[c];
#pragma unroll
      for (int i = 0; i < VQ_RI; ++i) {
        const float s = -2.f * acc[i][j] + ec;
        if (s < best[i]) {
          best[i] = s;
          bi[i] = k0 + c;
        }
      }
    }
    __syncthreads();  // en is rewritten by the next tile
  }

  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < VQ_RI; ++i) {
#pragma unroll
    for (int off = VQ_TX / 2; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], off, VQ_TX);
      const int k = __shfl_xor_sync(0xffffffffu, bi[i], off, VQ_TX);
      if (vq_better(s, k, best[i], bi[i])) {
        best[i] = s;
        bi[i] = k;
      }
    }
    // no finite score (a row of NaN or inf): index 0, as torch.argmin of
    // an all-inf row
    if (tx == 0) best_idx[ty + VQ_TY * i] = bi[i] == INT_MAX ? 0 : bi[i];
  }
  __syncthreads();

  const int rows = min(VQ_ROWS, N - r0);
  for (int r = tid; r < rows; r += VQ_THREADS) idx_out[r0 + r] = best_idx[r];
  float* out = one_hot + (size_t)r0 * K;
  for (size_t i = tid; i < (size_t)rows * K; i += VQ_THREADS) {
    const int r = (int)(i / K), c = (int)(i % K);
    out[i] = c == best_idx[r] ? 1.f : 0.f;
  }
}

extern "C" int gmt_vq_one_hot(const float* z, const float* e, float* one_hot, int* idx,
                              int N, int K, int D, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + VQ_ROWS - 1) / VQ_ROWS);
  vq_one_hot_kernel<<<grid, VQ_THREADS, 0, stream>>>(z, e, one_hot, idx, N, K, D);
  return cudaGetLastError();
}
