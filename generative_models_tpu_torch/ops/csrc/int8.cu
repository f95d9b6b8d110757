// Kernels I and J: the int8 products of --quantize serving, for sm_90a.
//
// Replaces: generative_models_tpu/ops/int8.py _gemm_kernel (:49, Kernel I,
// its int8 x int8 -> int32 instantiation) and _dequant_gemm_kernel (:60,
// Kernel J), both driven by _pallas_gemm (:71, pl.pallas_call at :101) from
// int8_matmul (:124).
//
//   I  out (M, N) int32 = x (M, K) int8 @ q (K, N) int8: w8a8, the per-row
//      quantized activations times the per-column quantized weights. The
//      sums are integers and exact, so I equals its plain version bitwise
//      whatever order it adds in.
//   J  out (M, N) f32 = bf16(x (M, K) f32) @ q (K, N) int8: w8a16, the
//      activations rounded to bf16 as they are staged (as Kernel G does) and
//      the int8 weights widened in shared memory, f32 sums.
// Neither rescales: acc * sx * scale (I) and y * scale (J) stay in torch,
// as the JAX package leaves them to XLA. The bf16 x bf16 -> f32
// instantiation of _gemm_kernel (:98) is not reached by int8_matmul and has
// no counterpart here.
//
// What bounds it on an H100: bytes. At the widest serving shape (made's
// hidden layer, x (64, 1024) @ q (1024, 1024)) I reads 64 KB of x and 1 MB of
// q and writes 256 KB of int32, 1.4 MB: 0.41 us at 3.35 TB/s, against 134 M
// int8 operations (0.07 us at 1979 TOP/s). J reads 256 KB of f32 x instead,
// 0.47 us. Both are called once a decode step or a forward with 64 rows,
// so a launch is short and the card is filled by few blocks. This first
// version runs on the CUDA cores from shared memory (tensor cores, mma.sync
// s8 and bf16, are a later step):
//   * a block owns a 64 x 32 output tile with 256 threads, each holding 4
//     rows x 2 columns strided by 16, so that neighbouring threads read
//     neighbouring shared-memory words and store neighbouring outputs;
//   * I: K streams through shared memory in 64-deep chunks; each thread
//     packs four consecutive k of x, and of q, into one 32-bit word as it
//     stages them (q's tile stored (n, k), k-contiguous), and __dp4a
//     multiplies and adds four int8 pairs into an int32 at a time;
//   * J: K streams in 32-deep chunks; x is rounded to bf16 and q widened as
//     they are staged into f32 shared memory (f32 holds every bf16 and every
//     int8 value exactly, so each product is the bf16 x bf16 product of the
//     TPU kernel), and f32 FMA accumulates in a fixed order;
//   * the next chunk's global loads are issued into registers before the
//     current chunk's arithmetic, so their latency overlaps it.
// Rows past M, columns past N and depth past K are masked in the kernel
// (masked bytes and values are 0); nothing is padded.

#include "common.cuh"

#include <cstdint>

constexpr int QG_BM = 64;                   // output rows a block
constexpr int QG_BN = 32;                   // output columns a block
constexpr int QG_THREADS = 256;
constexpr int QG_TX = 16;                   // threads across N
constexpr int QG_TY = QG_THREADS / QG_TX;   // threads across M
constexpr int QG_RM = QG_BM / QG_TY;        // 4 rows a thread
constexpr int QG_RN = QG_BN / QG_TX;        // 2 columns a thread

constexpr int I8_KC = 64;                                 // K bytes a chunk
constexpr int I8_KW = I8_KC / 4;                          // packed words a row
constexpr int I8_X_PER = QG_BM * I8_KW / QG_THREADS;      // x words a thread stages
constexpr int I8_Q_PER = QG_BN * I8_KW / QG_THREADS;      // q words a thread stages

constexpr int DQ_KC = 32;                                 // K a chunk
constexpr int DQ_X_PER = QG_BM * DQ_KC / QG_THREADS;      // x values a thread stages
constexpr int DQ_Q_PER = DQ_KC * QG_BN / QG_THREADS;      // q values a thread stages

static dim3 qg_grid(int M, int N) {
  return dim3((N + QG_BN - 1) / QG_BN, (M + QG_BM - 1) / QG_BM);
}

// ---------------------------------------------------------------- Kernel I

// x words of this chunk: word i is row i / I8_KW, bytes k0 + 4 (i % I8_KW)
// .. +3, byte b in bits 8b.. (consecutive threads: consecutive words of a row)
__device__ __forceinline__ void i8_load_x(const int8_t* __restrict__ x, int M, int K, int m0,
                                          int k0, int (&r)[I8_X_PER]) {
#pragma unroll
  for (int j = 0; j < I8_X_PER; ++j) {
    const int i = threadIdx.x + j * QG_THREADS;
    const int m = m0 + i / I8_KW, k = k0 + 4 * (i % I8_KW);
    unsigned v = 0;
    if (m < M) {
      const int8_t* row = x + (size_t)m * K;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + b < K) v |= (unsigned)(uint8_t)row[k + b] << (8 * b);
    }
    r[j] = (int)v;
  }
}

// q words of this chunk: word i is column i % QG_BN, rows k0 + 4 (i / QG_BN)
// .. +3 of that column (consecutive threads: consecutive columns)
__device__ __forceinline__ void i8_load_q(const int8_t* __restrict__ q, int K, int N, int k0,
                                          int n0, int (&r)[I8_Q_PER]) {
#pragma unroll
  for (int j = 0; j < I8_Q_PER; ++j) {
    const int i = threadIdx.x + j * QG_THREADS;
    const int n = n0 + i % QG_BN, k = k0 + 4 * (i / QG_BN);
    unsigned v = 0;
    if (n < N) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + b < K) v |= (unsigned)(uint8_t)q[(size_t)(k + b) * N + n] << (8 * b);
    }
    r[j] = (int)v;
  }
}

__global__ void __launch_bounds__(QG_THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                     int32_t* __restrict__ out, int M, int K, int N) {
  __shared__ int xs[QG_BM][I8_KW + 1];  // (m, k/4)
  __shared__ int qs[QG_BN][I8_KW + 1];  // (n, k/4): k-contiguous

  const int tx = threadIdx.x % QG_TX, ty = threadIdx.x / QG_TX;
  const int m0 = blockIdx.y * QG_BM, n0 = blockIdx.x * QG_BN;

  int acc[QG_RM][QG_RN];
#pragma unroll
  for (int i = 0; i < QG_RM; ++i)
#pragma unroll
    for (int j = 0; j < QG_RN; ++j) acc[i][j] = 0;

  int rx[I8_X_PER], rq[I8_Q_PER];
  i8_load_x(x, M, K, m0, 0, rx);
  i8_load_q(q, K, N, 0, n0, rq);
  for (int k0 = 0; k0 < K; k0 += I8_KC) {
#pragma unroll
    for (int j = 0; j < I8_X_PER; ++j) {
      const int i = threadIdx.x + j * QG_THREADS;
      xs[i / I8_KW][i % I8_KW] = rx[j];
    }
#pragma unroll
    for (int j = 0; j < I8_Q_PER; ++j) {
      const int i = threadIdx.x + j * QG_THREADS;
      qs[i % QG_BN][i / QG_BN] = rq[j];
    }
    __syncthreads();
    if (k0 + I8_KC < K) {  // the next chunk's loads fly during these dp4a
      i8_load_x(x, M, K, m0, k0 + I8_KC, rx);
      i8_load_q(q, K, N, k0 + I8_KC, n0, rq);
    }
#pragma unroll
    for (int w = 0; w < I8_KW; ++w) {
      int a[QG_RM], b[QG_RN];
#pragma unroll
      for (int i = 0; i < QG_RM; ++i) a[i] = xs[ty + QG_TY * i][w];
#pragma unroll
      for (int j = 0; j < QG_RN; ++j) b[j] = qs[tx + QG_TX * j][w];
#pragma unroll
      for (int i = 0; i < QG_RM; ++i)
#pragma unroll
        for (int j = 0; j < QG_RN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // xs and qs are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < QG_RM; ++i) {
    const int m = m0 + ty + QG_TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < QG_RN; ++j) {
      const int n = n0 + tx + QG_TX * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- Kernel J

// x (m, k) of this chunk, rounded to bf16 (consecutive threads: consecutive k)
__device__ __forceinline__ void dq_load_x(const float* __restrict__ x, int M, int K, int m0,
                                          int k0, float (&r)[DQ_X_PER]) {
#pragma unroll
  for (int j = 0; j < DQ_X_PER; ++j) {
    const int i = threadIdx.x + j * QG_THREADS;
    const int m = m0 + i / DQ_KC, k = k0 + i % DQ_KC;
    r[j] = (m < M && k < K) ? gmt_round_bf16(x[(size_t)m * K + k]) : 0.f;
  }
}

// q (k, n) of this chunk, widened (consecutive threads: consecutive n)
__device__ __forceinline__ void dq_load_q(const int8_t* __restrict__ q, int K, int N, int k0,
                                          int n0, float (&r)[DQ_Q_PER]) {
#pragma unroll
  for (int j = 0; j < DQ_Q_PER; ++j) {
    const int i = threadIdx.x + j * QG_THREADS;
    const int k = k0 + i / QG_BN, n = n0 + i % QG_BN;
    r[j] = (k < K && n < N) ? (float)q[(size_t)k * N + n] : 0.f;
  }
}

__global__ void __launch_bounds__(QG_THREADS)
    dequant_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[DQ_KC][QG_BM + 1];  // (k, m)
  __shared__ float qs[DQ_KC][QG_BN];      // (k, n)

  const int tx = threadIdx.x % QG_TX, ty = threadIdx.x / QG_TX;
  const int m0 = blockIdx.y * QG_BM, n0 = blockIdx.x * QG_BN;

  float acc[QG_RM][QG_RN];
#pragma unroll
  for (int i = 0; i < QG_RM; ++i)
#pragma unroll
    for (int j = 0; j < QG_RN; ++j) acc[i][j] = 0.f;

  float rx[DQ_X_PER], rq[DQ_Q_PER];
  dq_load_x(x, M, K, m0, 0, rx);
  dq_load_q(q, K, N, 0, n0, rq);
  for (int k0 = 0; k0 < K; k0 += DQ_KC) {
#pragma unroll
    for (int j = 0; j < DQ_X_PER; ++j) {
      const int i = threadIdx.x + j * QG_THREADS;
      xs[i % DQ_KC][i / DQ_KC] = rx[j];
    }
#pragma unroll
    for (int j = 0; j < DQ_Q_PER; ++j) {
      const int i = threadIdx.x + j * QG_THREADS;
      qs[i / QG_BN][i % QG_BN] = rq[j];
    }
    __syncthreads();
    if (k0 + DQ_KC < K) {  // the next chunk's loads fly during these FMAs
      dq_load_x(x, M, K, m0, k0 + DQ_KC, rx);
      dq_load_q(q, K, N, k0 + DQ_KC, n0, rq);
    }
#pragma unroll
    for (int kk = 0; kk < DQ_KC; ++kk) {
      float a[QG_RM], b[QG_RN];
#pragma unroll
      for (int i = 0; i < QG_RM; ++i) a[i] = xs[kk][ty + QG_TY * i];
#pragma unroll
      for (int j = 0; j < QG_RN; ++j) b[j] = qs[kk][tx + QG_TX * j];
#pragma unroll
      for (int i = 0; i < QG_RM; ++i)
#pragma unroll
        for (int j = 0; j < QG_RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // xs and qs are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < QG_RM; ++i) {
    const int m = m0 + ty + QG_TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < QG_RN; ++j) {
      const int n = n0 + tx + QG_TX * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// I: out (M, N) int32 = x (M, K) int8 @ q (K, N) int8.
extern "C" int gmt_int8_gemm(const int8_t* x, const int8_t* q, int32_t* out, int M, int K,
                             int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + QG_BM - 1) / QG_BM > 65535)
    return cudaErrorInvalidValue;
  int8_gemm_kernel<<<qg_grid(M, N), QG_THREADS, 0, stream>>>(x, q, out, M, K, N);
  return cudaGetLastError();
}

// J: out (M, N) f32 = bf16(x (M, K) f32) @ q (K, N) int8.
extern "C" int gmt_dequant_gemm(const float* x, const int8_t* q, float* out, int M, int K,
                                int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + QG_BM - 1) / QG_BM > 65535)
    return cudaErrorInvalidValue;
  dequant_gemm_kernel<<<qg_grid(M, N), QG_THREADS, 0, stream>>>(x, q, out, M, K, N);
  return cudaGetLastError();
}
