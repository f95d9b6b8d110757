// Kernels G and H: the masked dense layer of MADE, for sm_90a.
//
// Replaces: generative_models_tpu/ops/masked_dense.py _masked_matmul_kernel
// (:24, Kernel G) and _mask_out_matmul_kernel (:35, Kernel H), both driven by
// _pallas_masked_matmul (:49) from the masked_dense custom VJP (:113-160).
//
//   G  out (M, N) = A (M, K) @ (B (K, N) * mask (K, N)): the forward
//      x @ (w * m), and dX = g @ (w * m)^T read through the layout flag
//      trans_b (B and the mask stored (N, K), as w and m are), so neither
//      w^T nor m^T is copied through device memory. The mask is applied to
//      each B tile as it is staged, inside the K loop, as the TPU kernel
//      applies it to each (bk, bn) tile.
//   H  out (M, N) = mask (M, N) * (A^T @ B (K, N)), A stored (K, M): the
//      weight gradient dW = m * (x^T g), with A = x as it is stored, so x^T
//      is not copied either. The mask multiplies the f32 sum once,
//      after the last K step, so dW is exactly 0 off the mask.
//
// Operands: A and B are f32 in device memory (activations, gradients and
// the f32 weights the optimizer steps) and are rounded to bf16 as they are
// staged; products and sums are f32. That is the plain versions' arithmetic
// (ops/masked_dense.py: operands through .to(bfloat16).float()), and no
// separate cast pass over w runs before each launch. The mask is uint8 {0,1}.
//
// What bounds it on an H100: bytes. At made's widest layer (M=64, K=N=2048)
// G reads 16.8 MB of f32 w, 4.2 MB of mask and writes 0.5 MB, ~6.6 us at
// 3.35 TB/s, against 0.54 GFLOP (0.54 us at the bf16 tensor-core peak). H at
// (2048, 64) x (64, 2048) writes a 16.8 MB f32 dW and reads the 4.2 MB mask.
// This first version runs its products as f32 FMA on the CUDA cores from
// shared memory (tensor cores are a later step):
//   * one block owns a 32 x 32 output tile, so at M=64 a (64, 2048) output
//     is 128 blocks on the 132 SMs; its 256 threads are four K-groups of 64,
//     each thread holding a 4 x 4 sub-tile of the group's partial sums over
//     a quarter of every K chunk;
//   * K streams through shared memory in 64-deep chunks; the next chunk's
//     global loads are issued into registers before the current chunk's
//     FMAs, so their latency overlaps the arithmetic;
//   * at the end the four groups' partial sums meet in shared memory and
//     are added in a fixed order (group 0 + 1 + 2 + 3): no atomics, and the
//     result is bitwise the same from run to run;
//   * consecutive threads load consecutive addresses in every layout
//     (along K for row-major A and for B read as (N, K), along M or N
//     otherwise), and the output is stored a row of 32 floats at a time.
// Rows past M, columns past N and depth past K are masked in the kernel;
// nothing is padded.

#include "common.cuh"

#include <cstdint>

constexpr int MD_BM = 32;                                    // output rows a block
constexpr int MD_BN = 32;                                    // output columns a block
constexpr int MD_KC = 64;                                    // K chunk in shared memory
constexpr int MD_KG = 4;                                     // K-groups a block
constexpr int MD_TM = 4;                                     // rows a thread
constexpr int MD_TN = 4;                                     // columns a thread
constexpr int MD_GROUP = (MD_BM / MD_TM) * (MD_BN / MD_TN);  // 64 threads a group
constexpr int MD_THREADS = MD_KG * MD_GROUP;                 // 256
constexpr int MD_A_PER = MD_BM * MD_KC / MD_THREADS;         // A values a thread stages
constexpr int MD_B_PER = MD_KC * MD_BN / MD_THREADS;         // B values a thread stages
constexpr int MD_PAD = 4;                                    // keeps float4 rows aligned

// A(m, k) of this chunk into registers, rounded to bf16. Row-major A (M, K)
// (G): consecutive threads take consecutive k; TA, A stored (K, M) (H):
// consecutive m.
template <bool TA>
__device__ __forceinline__ void md_load_a(const float* __restrict__ A, int M, int K, int m0,
                                          int k0, float (&r)[MD_A_PER]) {
#pragma unroll
  for (int j = 0; j < MD_A_PER; ++j) {
    const int i = threadIdx.x + j * MD_THREADS;
    const int mm = TA ? i % MD_BM : i / MD_KC;
    const int kk = TA ? i / MD_BM : i % MD_KC;
    const int m = m0 + mm, k = k0 + kk;
    r[j] = (m < M && k < K)
               ? gmt_round_bf16(TA ? A[(size_t)k * M + m] : A[(size_t)m * K + k])
               : 0.f;
  }
}

template <bool TA>
__device__ __forceinline__ void md_store_a(float (*as)[MD_BM + MD_PAD],
                                           const float (&r)[MD_A_PER]) {
#pragma unroll
  for (int j = 0; j < MD_A_PER; ++j) {
    const int i = threadIdx.x + j * MD_THREADS;
    as[TA ? i / MD_BM : i % MD_KC][TA ? i % MD_BM : i / MD_KC] = r[j];
  }
}

// B(k, n) of this chunk into registers, rounded to bf16 and, for G, times
// the mask, which shares B's layout. Row-major B (K, N): consecutive n;
// trans_b, B stored (N, K): consecutive k.
template <bool TB, bool MASK_B>
__device__ __forceinline__ void md_load_b(const float* __restrict__ B,
                                          const uint8_t* __restrict__ mask, int K, int N,
                                          int k0, int n0, float (&r)[MD_B_PER]) {
#pragma unroll
  for (int j = 0; j < MD_B_PER; ++j) {
    const int i = threadIdx.x + j * MD_THREADS;
    const int nn = TB ? i / MD_KC : i % MD_BN;
    const int kk = TB ? i % MD_KC : i / MD_BN;
    const int k = k0 + kk, n = n0 + nn;
    float v = 0.f;
    if (k < K && n < N) {
      const size_t at = TB ? (size_t)n * K + k : (size_t)k * N + n;
      v = gmt_round_bf16(B[at]);
      if (MASK_B) v *= (float)mask[at];
    }
    r[j] = v;
  }
}

template <bool TB>
__device__ __forceinline__ void md_store_b(float (*bs)[MD_BN + MD_PAD],
                                           const float (&r)[MD_B_PER]) {
#pragma unroll
  for (int j = 0; j < MD_B_PER; ++j) {
    const int i = threadIdx.x + j * MD_THREADS;
    bs[TB ? i % MD_KC : i / MD_BN][TB ? i / MD_KC : i % MD_BN] = r[j];
  }
}

// The shared body of G (MASK_B) and H (MASK_OUT).
template <bool TA, bool TB, bool MASK_B, bool MASK_OUT>
__device__ __forceinline__ void md_gemm(const float* __restrict__ A, const float* __restrict__ B,
                                        const uint8_t* __restrict__ mask,
                                        float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float as[MD_KC][MD_BM + MD_PAD];  // (k, m)
  __shared__ __align__(16) float bs[MD_KC][MD_BN + MD_PAD];  // (k, n)
  __shared__ __align__(16) float red[MD_KG][MD_BM][MD_BN];   // each group's partial sums

  const int tid = threadIdx.x;
  const int g = tid / MD_GROUP, t = tid % MD_GROUP;
  const int ty = t / (MD_BN / MD_TN), tx = t % (MD_BN / MD_TN);
  const int m0 = blockIdx.y * MD_BM, n0 = blockIdx.x * MD_BN;

  float acc[MD_TM][MD_TN];
#pragma unroll
  for (int i = 0; i < MD_TM; ++i)
#pragma unroll
    for (int j = 0; j < MD_TN; ++j) acc[i][j] = 0.f;

  float ra[MD_A_PER], rb[MD_B_PER];
  md_load_a<TA>(A, M, K, m0, 0, ra);
  md_load_b<TB, MASK_B>(B, mask, K, N, 0, n0, rb);
  for (int k0 = 0; k0 < K; k0 += MD_KC) {
    md_store_a<TA>(as, ra);
    md_store_b<TB>(bs, rb);
    __syncthreads();
    if (k0 + MD_KC < K) {  // the next chunk's loads fly during these FMAs
      md_load_a<TA>(A, M, K, m0, k0 + MD_KC, ra);
      md_load_b<TB, MASK_B>(B, mask, K, N, k0 + MD_KC, n0, rb);
    }
    const int kb = g * (MD_KC / MD_KG);
#pragma unroll
    for (int u = 0; u < MD_KC / MD_KG; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kb + u][ty * MD_TM]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kb + u][tx * MD_TN]);
      const float av[MD_TM] = {a.x, a.y, a.z, a.w};
      const float bv[MD_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MD_TM; ++i)
#pragma unroll
        for (int j = 0; j < MD_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // as and bs are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < MD_TM; ++i)
    *reinterpret_cast<float4*>(&red[g][ty * MD_TM + i][tx * MD_TN]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  // every thread finishes some outputs: the groups' sums in a fixed order,
  // a row of 32 consecutive columns a warp
  for (int i = tid; i < MD_BM * MD_BN; i += MD_THREADS) {
    const int r = i / MD_BN, c = i % MD_BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = red[0][r][c];
#pragma unroll
    for (int q = 1; q < MD_KG; ++q) v += red[q][r][c];
    if (MASK_OUT) v *= (float)mask[(size_t)m * N + n];
    out[(size_t)m * N + n] = v;
  }
}

template <bool TB>
__global__ void __launch_bounds__(MD_THREADS)
    masked_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const uint8_t* __restrict__ mask, float* __restrict__ out, int M,
                         int K, int N) {
  md_gemm<false, TB, true, false>(x, w, mask, out, M, K, N);
}

__global__ void __launch_bounds__(MD_THREADS)
    mask_out_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const uint8_t* __restrict__ mask, float* __restrict__ out, int M,
                           int K, int N) {
  md_gemm<true, false, false, true>(a, b, mask, out, M, K, N);
}

static dim3 md_grid(int M, int N) {
  return dim3((N + MD_BN - 1) / MD_BN, (M + MD_BM - 1) / MD_BM);
}

// G: out (M, N) = x (M, K) @ (w * mask), w and mask (K, N), or (N, K) with
// trans_b.
extern "C" int gmt_masked_matmul(const float* x, const float* w, const uint8_t* mask,
                                 float* out, int M, int K, int N, int trans_b,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + MD_BM - 1) / MD_BM > 65535)
    return cudaErrorInvalidValue;
  if (trans_b)
    masked_matmul_kernel<true><<<md_grid(M, N), MD_THREADS, 0, stream>>>(x, w, mask, out, M, K, N);
  else
    masked_matmul_kernel<false><<<md_grid(M, N), MD_THREADS, 0, stream>>>(x, w, mask, out, M, K, N);
  return cudaGetLastError();
}

// H: out (M, N) = mask (M, N) * (a^T @ b (K, N)), a stored (K, M).
extern "C" int gmt_mask_out_matmul(const float* a, const float* b, const uint8_t* mask,
                                   float* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + MD_BM - 1) / MD_BM > 65535)
    return cudaErrorInvalidValue;
  mask_out_matmul_kernel<<<md_grid(M, N), MD_THREADS, 0, stream>>>(a, b, mask, out, M, K, N);
  return cudaGetLastError();
}
