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
// I is the s8 sibling of the same skeleton (stream_gemm.cuh sg_gemm_s8): a
// block owns 64 rows x 32 columns, K split over up to 8 blocks of a cluster
// summed in rank order through distributed shared memory, x and q streaming
// through I8_STAGES cp.async stages of 64 K bytes (9.5 KB a stage), the
// products on the int8 tensor cores (mma.sync m16n8k32, s32 sums). x's
// bytes land straight in the A operand's tile; each thread transposes the
// 4 x 16 block of q it copied into an (n, k) tile (__byte_perm) that
// ldmatrix reads as the B operand. Depth is refused past K = 133144, where
// K * 127^2 could overflow int32.
// The first design (64x32 output tiles, __dp4a on the CUDA cores over
// bytes gathered one at a time, N/32 blocks walking all of K; NVIDIA H100
// 80GB HBM3, 700 W) took 41.02 us at (64,1024)x(1024,1024), 5.35 us at
// 128->128, 19.70 us at 512->128, slower than torch._int_mm at 6 of the 11
// serving shapes.
// Rows past M, columns past N and depth past K are zero-filled on chip;
// nothing is padded in device memory. Where K or N is not a multiple of 16
// or an operand is not 16-byte aligned (VEC false), plain loads fill the
// same rings.

#include "common.cuh"
#include "stream_gemm.cuh"

#include <cstdint>

// ---------------------------------------------------------------- Kernel I

constexpr int I8_BN = 32;       // output columns a block: 2 warps
constexpr int I8_STAGES = 4;    // cp.async stages in flight
constexpr int I8_MAX_K = 133144;  // K * 127^2 <= 2^31 - 1

template <bool VEC>
__global__ void __launch_bounds__(I8_BN / 16 * 32)
    int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                     int32_t* __restrict__ out, int M, int K, int N, int kper) {
  sg_gemm_s8<I8_BN, VEC, I8_STAGES>(x, q, out, M, K, N, kper);
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

// I: out (M, N) int32 = x (M, K) int8 @ q (K, N) int8; K split over
// `splits` blocks of `kper` 64-deep stages each (plan_split_k in
// ops/common.py, kt=64).
extern "C" int gmt_int8_gemm(const int8_t* x, const int8_t* q, int32_t* out, int M, int K,
                             int N, int splits, int kper, cudaStream_t stream) {
  if (K > I8_MAX_K || !sg_plan_ok(M, K, N, I8_BN, splits, kper, SG8_KT))
    return cudaErrorInvalidValue;
  const size_t smem = sg8_smem_bytes<I8_BN, I8_STAGES>();
  if (sg_aligned16(x) && sg_aligned16(q) && K % 16 == 0 && N % 16 == 0)
    return sg_launch(int8_gemm_kernel<true>, I8_BN, M, N, splits, smem, stream, x, q, out, M, K,
                     N, kper);
  return sg_launch(int8_gemm_kernel<false>, I8_BN, M, N, splits, smem, stream, x, q, out, M, K,
                   N, kper);
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
