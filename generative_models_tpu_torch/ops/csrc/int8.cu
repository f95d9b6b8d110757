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
//      activations rounded to bf16 on chip (as Kernel G does) and the int8
//      weights widened to bf16 on chip (exact: |q| <= 127 fits bf16's 8-bit
//      significand), f32 sums.
// Neither rescales: acc * sx * scale (I) and y * scale (J) stay in torch,
// as the JAX package leaves them to XLA. The bf16 x bf16 -> f32
// instantiation of _gemm_kernel (:98) is not reached by int8_matmul and has
// no counterpart here.
//
// What bounds them on an H100: bytes. At the widest serving shape (made's
// hidden layer, x (64, 1024) @ q (1024, 1024)) I reads 64 KB of x and 1 MB of
// q and writes 256 KB of int32, 1.4 MB: 0.41 us at 3.35 TB/s, against 134 M
// int8 operations (0.07 us at 1979 TOP/s). J reads 256 KB of f32 x instead,
// 0.47 us; its 134 M bf16 products take 0.14 us on the tensor cores but 4.0
// us as f32 FMA on the CUDA cores. Both are called once a decode step or a
// forward with 64 rows, so a launch is short, and the card is filled only
// if K is split.
//
// J is the skeleton of stream_gemm.cuh: a block owns 64 rows x 32 columns,
// so q is read once at M=64; K is split over up to 8 blocks of a cluster
// (256 blocks at 1024x1024) summed in rank order through distributed shared
// memory, bitwise the same from run to run (made's causality under w8a16
// stays bitwise: q is exactly 0 off the folded masks); x and q stream
// through 4 cp.async stages (9 KB a stage), are converted to bf16 tiles
// and multiplied with mma.sync, q's (k, n) tile read by ldmatrix.trans.
// Measured (PERF.md §6), a fixed cost of launch, first tile and cluster
// reduction and then a block's chain of one barrier and its shared-memory
// round trips a tile hold it back more than the bytes do: it stays many
// times its byte bound, and above the library call's time.
// The first design (PR 5: 64x32 output tiles, f32 FMA on the CUDA cores, N/32
// blocks walking all of K; NVIDIA H100 80GB HBM3, 700 W) took 68.22 us at
// (64,1024)x(1024,1024), 9.03 us at 128->128, 33.46 us at 512->128.
//
// I (the first design): on the CUDA cores from shared memory (tensor cores,
// mma.sync s8, are a later step):
//   * a block owns a 64 x 32 output tile with 256 threads, each holding 4
//     rows x 2 columns strided by 16, so that neighbouring threads read
//     neighbouring shared-memory words and store neighbouring outputs;
//   * K streams through shared memory in 64-deep chunks; each thread
//     packs four consecutive k of x, and of q, into one 32-bit word as it
//     stages them (q's tile stored (n, k), k-contiguous), and __dp4a
//     multiplies and adds four int8 pairs into an int32 at a time;
//   * the next chunk's global loads are issued into registers before the
//     current chunk's arithmetic, so their latency overlaps it.
// Rows past M, columns past N and depth past K are masked in the kernels
// (masked bytes and values are 0); nothing is padded.

#include "common.cuh"
#include "stream_gemm.cuh"

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

constexpr int DQ_BN = 32;      // output columns a block: 2 warps
constexpr int DQ_STAGES = 4;   // cp.async stages in flight

// J's B operand for stream_gemm.cuh: int8 q (K, N), staged raw and widened
// to a bf16 (k, n) tile. A thread owns items of 16 consecutive bytes of a
// row (one 16-byte copy), which it copies and converts.
struct DqInt8Q {
  using Elem = int8_t;
  static constexpr int BN = DQ_BN;
  static constexpr bool K_MAJOR = false;
  static constexpr int RAW = SG_KT * BN;
  static constexpr int LD = BN + 8;  // ldmatrix rows on distinct banks
  static constexpr int TILE = SG_KT * LD;
  static constexpr int CH = BN / 16;  // items a row

  template <bool VEC, int THREADS>
  static __device__ __forceinline__ void load(unsigned char* raw, const int8_t* __restrict__ q,
                                              const uint8_t*, int K, int N, int k0, int n0) {
    int8_t* qr = reinterpret_cast<int8_t*>(raw);
#pragma unroll
    for (int j = 0; j < SG_KT * CH / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 16;
      const int k = k0 + r, n = n0 + c;
      if (VEC) {
        const bool ok = k < K && n < N;
        gmt_cp_async16(qr + r * BN + c, ok ? q + (size_t)k * N + n : q, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          qr[r * BN + c + e] = (k < K && n + e < N) ? q[(size_t)k * N + n + e] : 0;
      }
    }
  }

  template <int THREADS>
  static __device__ __forceinline__ void convert(const unsigned char* raw, __nv_bfloat16* bs) {
#pragma unroll
    for (int j = 0; j < SG_KT * CH / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + c);
      const unsigned w4[4] = {v.x, v.y, v.z, v.w};
      unsigned packed[8];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const unsigned bits = w4[e / 4] >> (8 * (e % 4));
        packed[e / 2] = gmt_pack_bf16((float)(int8_t)(bits & 0xffu),
                                      (float)(int8_t)((bits >> 8) & 0xffu));
      }
      uint4* dst = reinterpret_cast<uint4*>(bs + r * LD + c);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(DQ_BN / 16 * 32)
    dequant_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        float* __restrict__ out, int M, int K, int N, int kper) {
  sg_gemm<DqInt8Q, VEC, DQ_STAGES>(x, q, nullptr, out, M, K, N, kper);
}

// I: out (M, N) int32 = x (M, K) int8 @ q (K, N) int8.
extern "C" int gmt_int8_gemm(const int8_t* x, const int8_t* q, int32_t* out, int M, int K,
                             int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + QG_BM - 1) / QG_BM > 65535)
    return cudaErrorInvalidValue;
  int8_gemm_kernel<<<qg_grid(M, N), QG_THREADS, 0, stream>>>(x, q, out, M, K, N);
  return cudaGetLastError();
}

// J: out (M, N) f32 = bf16(x (M, K) f32) @ q (K, N) int8; K split over
// `splits` blocks of `kper` 32-deep tiles each (plan_split_k in
// ops/common.py).
extern "C" int gmt_dequant_gemm(const float* x, const int8_t* q, float* out, int M, int K,
                                int N, int splits, int kper, cudaStream_t stream) {
  if (!sg_plan_ok(M, K, N, DQ_BN, splits, kper)) return cudaErrorInvalidValue;
  const size_t smem = sg_smem_bytes<DqInt8Q, DQ_STAGES>();
  if (sg_aligned16(x) && sg_aligned16(q) && K % 4 == 0 && N % 16 == 0)
    return sg_launch(dequant_gemm_kernel<true>, DQ_BN, M, N, splits, smem, stream, x, q, out, M,
                     K, N, kper);
  return sg_launch(dequant_gemm_kernel<false>, DQ_BN, M, N, splits, smem, stream, x, q, out, M,
                   K, N, kper);
}
