// Kernels G and H: the masked dense layer of MADE, for sm_90a.
//
// Replaces: generative_models_tpu/ops/masked_dense.py _masked_matmul_kernel
// (:24, Kernel G) and _mask_out_matmul_kernel (:35, Kernel H), both driven by
// _pallas_masked_matmul (:49) from the masked_dense custom VJP (:113-160).
//
//   G  out (M, N) = bf16(A (M, K)) @ (bf16(B (K, N)) * mask (K, N)): the
//      forward x @ (w * m), and dX = g @ (w * m)^T read through the layout
//      flag trans_b (B and the mask stored (N, K), as w and m are), so
//      neither w^T nor m^T is copied through device memory. The mask is
//      applied to each B tile as it is staged, inside the K loop, as the TPU
//      kernel applies it to each (bk, bn) tile.
//   H  out (M, N) = mask (M, N) * (A^T @ B (K, N)), A stored (K, M): the
//      weight gradient dW = m * (x^T g), with A = x as it is stored, so x^T
//      is not copied either. The mask multiplies the f32 sum once,
//      after the last K step, so dW is exactly 0 off the mask.
//
// Operands: A and B are f32 in device memory (activations, gradients and
// the f32 weights the optimizer steps) and are rounded to bf16 (to nearest
// even) on chip; products and sums are f32. That is the plain versions'
// arithmetic (ops/masked_dense.py: operands through .to(bfloat16).float()),
// and no separate cast pass over w runs before each launch. The mask is
// uint8 {0,1}; bf16(w) * m is exact, and a masked product is an exact zero,
// which leaves a tensor-core sum unchanged (made's causality stays bitwise).
//
// What bounds G on an H100: bytes. At made's widest layer (M=64, K=N=2048)
// G reads 16.8 MB of f32 w, 4.2 MB of mask and 0.5 MB of x and writes 0.5
// MB: 6.57 us at 3.35 TB/s, against 0.54 GFLOP (0.54 us at the bf16
// tensor-core peak, but 8.0 us at the f32 CUDA-core rate: only the tensor
// cores can bring G near its bound). G is the skeleton of stream_gemm.cuh:
// a block owns 64 rows x 64 columns, so w and its mask are read once at
// M=64; K is split over up to 8 blocks of a cluster (256 blocks at
// 2048x2048, two an SM) summed in rank order through distributed shared
// memory; w, the mask and x stream through 3 cp.async stages (18 KB a
// stage), are converted to bf16 tiles (w rounded and masked) and multiplied
// with mma.sync. Both layouts share the kernel: (K, N) tiles are read by
// ldmatrix.trans, (N, K) tiles by ldmatrix. Measured (PERF.md §6), it takes
// 16.0 us at 2048x2048 with L2 warm and 20.4 us flushed, 2.4x and 3.1x its
// bound: a block's chain of one barrier and its shared-memory round trips a
// 32-deep tile, and a fixed ~5 us of launch, first tile and cluster
// reduction, hold it back more than the bytes do.
// The first design (PR 4: 32x32 output tiles, f32 FMA on the CUDA cores, K
// walked whole by each block; NVIDIA H100 80GB HBM3, 700 W) took 99.20 us at
// (64,2048)x(2048,2048) with L2 warm, 178.0 us with it flushed, 40.21 us at
// 784->2048, 99.37 us at 2048->784, 95.37 us for dX.
//
// H (unchanged, the first design; f32 FMA from shared memory): at (2048, 64)
// x (64, 2048) it writes a 16.8 MB f32 dW and reads the 4.2 MB mask.
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
// Rows past M, columns past N and depth past K are masked in the kernels;
// nothing is padded.

#include "common.cuh"
#include "stream_gemm.cuh"

#include <cstdint>

// ---------------------------------------------------------------- Kernel H

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

// The body of H (MASK_OUT), the first design's shared body of G and H.
// G now runs on stream_gemm.cuh; the layout and mask flags it used stay,
// so that H's instantiation is unchanged until H is redesigned.
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

// ---------------------------------------------------------------- Kernel G

constexpr int MM_BN = 64;      // output columns a block: 4 warps
constexpr int MM_STAGES = 3;   // cp.async stages in flight

// G's B operand for stream_gemm.cuh: f32 w and its uint8 mask, (K, N)
// (TB false) or (N, K) (TB true), staged raw and converted to
// bf16(w) * mask in a bf16 tile of the same layout. A thread owns items of
// 16 consecutive elements of a row (four 16-byte copies of w, one of the
// mask), which it copies and converts.
template <bool TB>
struct MmMaskedW {
  using Elem = float;
  static constexpr int BN = MM_BN;
  static constexpr bool K_MAJOR = TB;
  static constexpr int ROWS = TB ? BN : SG_KT;  // raw rows: n (TB) or k
  static constexpr int COLS = TB ? SG_KT : BN;  // raw row length
  static constexpr int W_RAW = ROWS * COLS * 4;
  static constexpr int RAW = W_RAW + ROWS * COLS;
  static constexpr int LD = COLS + 8;  // ldmatrix rows on distinct banks
  static constexpr int TILE = ROWS * LD;
  static constexpr int CH = COLS / 16;  // items a row

  template <bool VEC, int THREADS>
  static __device__ __forceinline__ void load(unsigned char* raw, const float* __restrict__ w,
                                              const uint8_t* __restrict__ mask, int K, int N,
                                              int k0, int n0) {
    float* wr = reinterpret_cast<float*>(raw);
    uint8_t* mr = raw + W_RAW;
    const int r0 = TB ? n0 : k0, c0 = TB ? k0 : n0;  // (row, column) origin in w
    const int R = TB ? N : K, C = TB ? K : N;        // w's rows and row length
#pragma unroll
    for (int j = 0; j < ROWS * CH / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 16;
      const size_t at = (size_t)(r0 + r) * C + c0 + c;
      if (VEC) {
        const bool ok = r0 + r < R && c0 + c < C;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gmt_cp_async16(wr + r * COLS + c + 4 * q, ok ? w + at + 4 * q : w, ok);
        gmt_cp_async16(mr + r * COLS + c, ok ? mask + at : mask, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const bool ok = r0 + r < R && c0 + c + e < C;
          wr[r * COLS + c + e] = ok ? w[at + e] : 0.f;
          mr[r * COLS + c + e] = ok ? mask[at + e] : 0;
        }
      }
    }
  }

  template <int THREADS>
  static __device__ __forceinline__ void convert(const unsigned char* raw, __nv_bfloat16* bs) {
    const float* wr = reinterpret_cast<const float*>(raw);
    const uint8_t* mr = raw + W_RAW;
#pragma unroll
    for (int j = 0; j < ROWS * CH / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = (i % CH) * 16;
      float v[16];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(v + 4 * q) =
            *reinterpret_cast<const float4*>(wr + r * COLS + c + 4 * q);
      const uint4 m = *reinterpret_cast<const uint4*>(mr + r * COLS + c);
      const unsigned mw[4] = {m.x, m.y, m.z, m.w};
      unsigned packed[8];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const unsigned bits = mw[e / 4] >> (8 * (e % 4));
        packed[e / 2] = gmt_pack_bf16(gmt_round_bf16(v[e]) * (float)(bits & 0xffu),
                                      gmt_round_bf16(v[e + 1]) * (float)((bits >> 8) & 0xffu));
      }
      uint4* dst = reinterpret_cast<uint4*>(bs + r * LD + c);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  }
};

template <bool TB, bool VEC>
__global__ void __launch_bounds__(MM_BN / 16 * 32)
    masked_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const uint8_t* __restrict__ mask, float* __restrict__ out, int M,
                         int K, int N, int kper) {
  sg_gemm<MmMaskedW<TB>, VEC, MM_STAGES>(x, w, mask, out, M, K, N, kper);
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

template <bool TB, bool VEC>
static cudaError_t mm_launch(const float* x, const float* w, const uint8_t* mask, float* out,
                             int M, int K, int N, int splits, int kper, cudaStream_t stream) {
  return sg_launch(masked_matmul_kernel<TB, VEC>, MM_BN, M, N, splits,
                   sg_smem_bytes<MmMaskedW<TB>, MM_STAGES>(), stream, x, w, mask, out, M, K,
                   N, kper);
}

// G: out (M, N) = x (M, K) @ (w * mask), w and mask (K, N), or (N, K) with
// trans_b; K split over `splits` blocks of `kper` 32-deep tiles each
// (plan_split_k in ops/common.py).
extern "C" int gmt_masked_matmul(const float* x, const float* w, const uint8_t* mask,
                                 float* out, int M, int K, int N, int trans_b, int splits,
                                 int kper, cudaStream_t stream) {
  if (!sg_plan_ok(M, K, N, MM_BN, splits, kper)) return cudaErrorInvalidValue;
  const bool vec = sg_aligned16(x) && sg_aligned16(w) && sg_aligned16(mask) && K % 4 == 0 &&
                   (trans_b ? K : N) % 16 == 0;
  if (trans_b)
    return vec ? mm_launch<true, true>(x, w, mask, out, M, K, N, splits, kper, stream)
               : mm_launch<true, false>(x, w, mask, out, M, K, N, splits, kper, stream);
  return vec ? mm_launch<false, true>(x, w, mask, out, M, K, N, splits, kper, stream)
             : mm_launch<false, false>(x, w, mask, out, M, K, N, splits, kper, stream);
}

// H: out (M, N) = mask (M, N) * (a^T @ b (K, N)), a stored (K, M).
extern "C" int gmt_mask_out_matmul(const float* a, const float* b, const uint8_t* mask,
                                   float* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + MD_BM - 1) / MD_BM > 65535)
    return cudaErrorInvalidValue;
  mask_out_matmul_kernel<<<md_grid(M, N), MD_THREADS, 0, stream>>>(a, b, mask, out, M, K, N);
  return cudaGetLastError();
}
