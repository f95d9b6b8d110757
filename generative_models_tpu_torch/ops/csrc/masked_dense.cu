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
// What bounds H on an H100: bytes written. At (2048, 64) x (64, 2048) it
// writes a 16.8 MB f32 dW and reads the 4.2 MB mask and 1 MB of f32 x and g:
// 6.57 us at 3.35 TB/s, against 0.54 GFLOP (0.54 us at the bf16 tensor-core
// peak, but 8.0 us at the f32 CUDA-core rate). H is an output-tile kernel
// (stream_gemm.cuh streams a long K against few rows; H is the opposite
// shape, a short K against a wide output):
//   * a block owns a 64 x 128 tile of dW (512 blocks at 2048x2048, 208 at
//     784x2048), eight warps of 32 x 32 accumulator fragments each;
//   * the tile's mask comes in by 16-byte cp.async as soon as the block
//     starts and lands while the products run;
//   * K is staged 64 deep at a time (the whole of it at made's batch of
//     64): each thread issues all of its 16-byte loads of a and b at once,
//     then rounds them to bf16 into padded shared-memory tiles (row stride
//     + 8 elements, so ldmatrix rows fall on distinct banks) stored as
//     they are, (k, m) and (k, n); ldmatrix.trans gives both the A
//     fragments of a^T and the B fragments of b, and mma.sync m16n8k16
//     multiplies them; depth past K loads as zeros;
//   * the epilogue multiplies each f32 sum by its mask byte, as the plain
//     version's m * (a^T b), so dW is exactly 0 off the mask, and stores
//     it straight from the fragments, 8 bytes a lane: a warp's store
//     covers whole 32-byte sectors (four lanes a row segment). Rows staged
//     through shared memory, 16 bytes a lane, were measured slower with L2
//     flushed (PERF.md section 6);
//   * each tile's K is summed by one warp in a fixed order, with no split
//     and no atomics, so the result is bitwise the same run to run;
//   * rows past M, columns past N and depth past K are masked in the
//     kernel; where a pointer is not 16-byte aligned, or M is not a
//     multiple of 4 or N of 16, the template flag VEC is off and every
//     load and store is a plain one (G's VEC does the same).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, row
// 10): 10.45 us at (2048, 64) x (64, 2048) with L2 warm and 12.07 us with
// it flushed (1.8x the byte bound: a block loads, multiplies and only then
// stores, so its stores do not overlap the next wave's loads), 4.89 and
// 6.06 us at (784, 64) x (64, 2048). The first design (32 x 32 tiles, four
// K-groups of f32 FMA on the CUDA cores, summed through shared memory) took
// 60.98, 83.38, 25.84 and 36.02 us.

#include "common.cuh"
#include "stream_gemm.cuh"

#include <cstdint>

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

template <bool TB, bool VEC>
static cudaError_t mm_launch(const float* x, const float* w, const uint8_t* mask, float* out,
                             int M, int K, int N, int splits, int kper, cudaStream_t stream) {
  return sg_launch(masked_matmul_kernel<TB, VEC>, MM_BN, M, N, splits,
                   sg_smem_bytes<MmMaskedW<TB>, MM_STAGES>(), stream, x, w, mask, out, M, K,
                   N, kper);
}

// ---------------------------------------------------------------- Kernel H

constexpr int HM_BM = 64, HM_BN = 128;  // dW rows (a's columns) and columns a block
constexpr int HM_WM = 32, HM_WN = 32;   // a warp's patch: 2 x 4 m16n8 fragments
constexpr int HM_KC = 64;               // depth of a staged chunk of a and b
constexpr int HM_THREADS = HM_BM / HM_WM * (HM_BN / HM_WN) * 32;  // 256: 2 x 4 warps
// blocks an SM on the 16-byte route; the plain-load route's scalar loads
// take more registers, and it keeps 3 so as not to spill. The tile, the
// warp patch and the caps were chosen by ops/knob_sweep.py (PERF.md
// section 6).
constexpr int HM_MINB = 2, HM_MINB_PLAIN = 3;
constexpr int HM_LDA = HM_BM + 8, HM_LDB = HM_BN + 8;  // bf16 tile row strides
constexpr int HM_LDM = HM_BN + 16;                     // mask tile row stride (bytes)
constexpr int HM_AB_BYTES = HM_KC * (HM_LDA + HM_LDB) * 2;

// rows k0 .. k0 + HM_KC - 1, columns c0 .. c0 + COLS - 1 of an f32 (K, R)
// matrix (a or b as stored) -> a bf16 tile [HM_KC][COLS + 8]; zero past K
// and R. Every load of the thread is issued before the first is used.
template <int COLS, bool VEC>
__device__ __forceinline__ void hm_stage(__nv_bfloat16* tile, const float* __restrict__ src,
                                         int K, int R, int k0, int c0) {
  constexpr int C4 = COLS / 4, LD = COLS + 8, PER = HM_KC * C4 / HM_THREADS;
  static_assert(HM_KC * C4 % HM_THREADS == 0, "whole loads a thread");
  float4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * HM_THREADS;
    const int k = k0 + i / C4, col = c0 + (i % C4) * 4;
    const float* p = src + (size_t)k * R + col;
    if (VEC) {
      v[j] = k < K && col < R ? *reinterpret_cast<const float4*>(p)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[j].x = k < K && col < R ? p[0] : 0.f;
      v[j].y = k < K && col + 1 < R ? p[1] : 0.f;
      v[j].z = k < K && col + 2 < R ? p[2] : 0.f;
      v[j].w = k < K && col + 3 < R ? p[3] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * HM_THREADS;
    *reinterpret_cast<uint2*>(tile + (i / C4) * LD + (i % C4) * 4) =
        make_uint2(gmt_pack_bf16(v[j].x, v[j].y), gmt_pack_bf16(v[j].z, v[j].w));
  }
}

// the (HM_BM, HM_BN) mask tile at (m0, n0) -> ms[HM_BM][HM_LDM], zero past M
// and N: 16-byte cp.async (VEC; the caller commits) or byte loads
template <bool VEC>
__device__ __forceinline__ void hm_load_mask(uint8_t* ms, const uint8_t* __restrict__ mask,
                                             int M, int N, int m0, int n0) {
  constexpr int CH = HM_BN / 16;
#pragma unroll
  for (int j = 0; j < HM_BM * CH / HM_THREADS; ++j) {
    const int i = threadIdx.x + j * HM_THREADS;
    const int r = i / CH, c = (i % CH) * 16;
    const int m = m0 + r, n = n0 + c;
    const uint8_t* src = mask + (size_t)m * N + n;
    if (VEC) {
      const bool ok = m < M && n < N;
      gmt_cp_async16(ms + r * HM_LDM + c, ok ? src : mask, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) ms[r * HM_LDM + c + e] = m < M && n + e < N ? src[e] : 0;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(HM_THREADS, VEC ? HM_MINB : HM_MINB_PLAIN)
    mask_out_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const uint8_t* __restrict__ mask, float* __restrict__ out, int M,
                           int K, int N) {
  __shared__ __align__(16) unsigned char hm_smem[HM_AB_BYTES + HM_BM * HM_LDM];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(hm_smem);  // (k, m)
  __nv_bfloat16* bs = as + HM_KC * HM_LDA;                         // (k, n)
  uint8_t* ms = hm_smem + HM_AB_BYTES;
  const int m0 = blockIdx.y * HM_BM, n0 = blockIdx.x * HM_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  const int wm0 = (warp / (HM_BN / HM_WN)) * HM_WM, wn0 = (warp % (HM_BN / HM_WN)) * HM_WN;

  hm_load_mask<VEC>(ms, mask, M, N, m0, n0);
  if (VEC) gmt_cp_async_commit();

  float acc[HM_WM / 16][HM_WN / 8][4];
#pragma unroll
  for (int mi = 0; mi < HM_WM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < HM_WN / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += HM_KC) {
    if (k0 > 0) __syncthreads();  // every warp is past the previous chunk
    hm_stage<HM_BM, VEC>(as, a, K, M, k0, m0);
    hm_stage<HM_BN, VEC>(bs, b, K, N, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HM_KC / 16; ++kk) {
      if (k0 + 16 * kk >= K) break;  // all zeros from here
      // a^T's A fragments from the (k, m) tile and b's B fragments from the
      // (k, n) tile, both by ldmatrix.trans (fragment maps: mma.cuh)
      unsigned af[HM_WM / 16][4], bf[HM_WN / 16][4];
#pragma unroll
      for (int mi = 0; mi < HM_WM / 16; ++mi)
        gmt_ldmatrix_x4_trans(af[mi], as + (16 * kk + (lane / 16) * 8 + lane % 8) * HM_LDA +
                                          wm0 + 16 * mi + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int np = 0; np < HM_WN / 16; ++np)
        gmt_ldmatrix_x4_trans(bf[np], bs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * HM_LDB +
                                          wn0 + 16 * np + (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < HM_WM / 16; ++mi)
#pragma unroll
        for (int np = 0; np < HM_WN / 16; ++np) {
          gmt_mma_bf16(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
          gmt_mma_bf16(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
        }
    }
  }

  if (VEC) gmt_cp_async_wait<0>();
  __syncthreads();  // the mask tile is in for every thread
#pragma unroll
  for (int mi = 0; mi < HM_WM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < HM_WN / 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm0 + 16 * mi + g + 8 * h, cl = wn0 + 8 * ni + c;
        const int m = m0 + r, n = n0 + cl;
        if (m >= M) continue;
        const uint8_t* mk = ms + r * HM_LDM + cl;
        const float x0 = acc[mi][ni][2 * h] * (float)mk[0];
        const float x1 = acc[mi][ni][2 * h + 1] * (float)mk[1];
        float* dst = out + (size_t)m * N + n;
        if (VEC) {
          if (n < N) *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          if (n < N) dst[0] = x0;
          if (n + 1 < N) dst[1] = x1;
        }
      }
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
  if (M <= 0 || N <= 0 || K < 0 || (M + HM_BM - 1) / HM_BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + HM_BN - 1) / HM_BN, (M + HM_BM - 1) / HM_BM);
  const bool vec = sg_aligned16(a) && sg_aligned16(b) && sg_aligned16(mask) &&
                   sg_aligned16(out) && M % 4 == 0 && N % 16 == 0;
  if (vec)
    mask_out_matmul_kernel<true><<<grid, HM_THREADS, 0, stream>>>(a, b, mask, out, M, K, N);
  else
    mask_out_matmul_kernel<false><<<grid, HM_THREADS, 0, stream>>>(a, b, mask, out, M, K, N);
  return cudaGetLastError();
}
