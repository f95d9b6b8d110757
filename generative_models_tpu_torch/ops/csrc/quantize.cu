// Kernel F (vq_one_hot): the VQ-VAE codebook search, for sm_90a. For each
// row of z (N, D) f32, the nearest code of the codebook e (K, D) f32 by
// argmin over k of -2 z.e_k + |e_k|^2 (|z|^2 is the same for every k), in
// torch.argmin's order: a NaN score below every number (the first NaN
// wins), then the lower score, then the lower index; written as a one-hot
// (N, K) f32 row and as the int64 index.
//
// Replaces: generative_models_tpu/ops/quantize.py _vq_kernel (:23, called by
// vq_one_hot :56). The TPU kernel holds the whole padded codebook in VMEM
// and gives up on XLA past a VMEM budget (quantize.py:80-86); this one
// streams the codebook through shared memory in K-tiles and D in chunks,
// so it takes any N, K and D, and has no such gate. Infinite inputs are
// outside its contract: the split below turns an inf into a NaN.
//
// What bounds it on an H100: bytes. At the training shape (N=3136, K=D=64)
// it reads 0.82 MB of z and codebook and writes the 0.80 MB one-hot and the
// 25 KB index, 0.49 us at 3.35 TB/s; at a 1024-code book (N=12544) the
// one-hot is 51 MB, 16.4 us. The products, 3 tf32 ones a multiply-add on
// the tensor cores, take 0.16 and 9.96 us at 495 TFLOP/s (as f32 FMA on the
// CUDA cores, the first design's, they took 0.39 and 24.5 us at 67 TFLOP/s).
// At the training shape a launch costs its latency chain (the kernel takes
// some 8x its byte bound there); at a 1024-code book every block reads the
// whole codebook from L2 again, with a tile's copies, products and scores
// in one dependent chain a stage. The design:
//   * one warp a 16-row strip of z and VQ_CW codes of each K-tile: a block
//     is VQ_WM x VQ_WN warps, VQ_WM strips (16 * VQ_WM rows) by VQ_WN warps
//     along the codes, so a K-tile of VQ_KT codes is read once for VQ_WM
//     strips; the knob sweep (ops/knob_sweep.py) chose one strip, 196
//     blocks at N=3136;
//   * the z strip and each K-tile arrive by 16-byte cp.async (4-byte where
//     a row or a pointer is not 16-byte aligned), zero-filled past N, K and
//     D (the zeros add exactly 0, so every chunk runs its 8 k8 steps
//     without a branch), through L1, into a ring of VQ_STAGES buffers with
//     one barrier a stage; D streams in VQ_DC-wide chunks with the tiles.
//     Where D fits one chunk the strip's fragments are split once and held
//     in registers for every K-tile;
//   * the product on the tensor cores at f32 accuracy, 3xTF32: each operand
//     split as hi = tf32(x), lo = tf32(x - hi) (mma.cuh gmt_tf32_split), and
//     lo.hi, hi.lo and hi.hi each summed over the k8 steps into an
//     accumulator of its own (mma.sync m16n8k8 tf32, f32 sums: six
//     independent chains a warp), the small products' sum added to hi.hi's
//     once the K-tile's chunks are done. One tf32 product would flip
//     assignments against the f32 reference (tests/test_torch_quantize.py);
//   * |e_k|^2 in f32 from the same B fragments: each lane sums the squares
//     of the elements it loads, and the four lanes of a code meet by
//     shuffles;
//   * each score becomes an int key in torch.argmin's order (vq_key), and
//     each lane keeps, for its two rows, a running (best key, index) over
//     its codes in ascending order by branch-free compares; the four lanes
//     of a row meet by shuffles and the VQ_WN warps of a strip in shared
//     memory, in a fixed order under the same rule, so two launches are
//     bitwise equal (no atomics);
//   * the one-hot written row-major by consecutive threads in 16-byte
//     stores from the block's indices, (row, code) stepped without a
//     division; the int64 index straight from the kernel.

#include "common.cuh"
#include "mma.cuh"

#include <climits>

constexpr int VQ_WN = 4, VQ_CW = 16;  // warps along the codes, codes a warp of each K-tile
constexpr int VQ_WM = 1;    // 16-row strips a block
constexpr int VQ_MINB = 2;  // blocks an SM the register cap aims at
constexpr int VQ_STAGES = 2;  // (K-tile, D-chunk) buffers in the ring
constexpr int VQ_DC = 64;     // D-chunk of a stage
constexpr int VQ_ROWS = 16 * VQ_WM, VQ_THREADS = 32 * VQ_WM * VQ_WN;
constexpr int VQ_KT = VQ_WN * VQ_CW;  // codes of a K-tile
constexpr int VQ_NT = VQ_CW / 8;      // n8 tiles a warp
constexpr int VQ_KS = VQ_DC / 8;      // k8 steps a chunk
constexpr int VQ_LD = VQ_DC + 4;      // shared row stride (floats): 16-byte rows, conflict-free reads
static_assert(VQ_CW % 8 == 0 && VQ_DC % 8 == 0, "codes a warp and the D-chunk are k8/n8 tiles");

// a score as an int whose order is torch.argmin's: NaN below every number,
// -0 equal to +0, then the floats' order; so the search is integer
// compares, the lower index winning among equal keys
__device__ __forceinline__ int vq_key(float s) {
  const int i = __float_as_int(s + 0.f);
  return isnan(s) ? INT_MIN : i >= 0 ? i : i ^ 0x7fffffff;
}

// (k, i) beats (bk, bi): a lower key, or the same key at a lower index
__device__ __forceinline__ bool vq_better(int k, int i, int bk, int bi) {
  return k < bk || (k == bk && i < bi);
}

// shared-memory buffers of the ring: where D is one chunk, the z strip is
// loaded once (one buffer) and only the codebook's chunks stream
struct VqRing {
  int nbuf, zbuf;  // codebook buffers, z buffers
  __host__ __device__ VqRing(int stages, int n_dc)
      : nbuf(stages < VQ_STAGES ? stages : VQ_STAGES), zbuf(n_dc > 1 ? nbuf : 1) {}
  __host__ __device__ size_t floats() const {
    return (size_t)(zbuf * VQ_ROWS + nbuf * VQ_KT) * VQ_LD;
  }
};

// cp.async of rows [row0, row0 + ROWS) x columns [d0, d0 + VQ_DC) of a
// row-major (n_rows, D) f32 matrix into dst (ROWS x VQ_LD), zero past n_rows
// and D, so every chunk is VQ_KS whole k8 steps; VEC: 16-byte pieces through
// L1 (D % 4 == 0 and the base 16-byte aligned), else 4-byte ones
template <int ROWS, bool VEC>
__device__ __forceinline__ void vq_load(float* dst, const float* src, int row0, int n_rows,
                                        int d0, int D, int tid) {
  constexpr int W = VEC ? 4 : 1, PIECES = VQ_DC / W;  // pieces a row
  for (int i = tid; i < ROWS * PIECES; i += VQ_THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * W;
    const bool ok = row0 + r < n_rows && d0 + c < D;
    const float* p = ok ? src + (size_t)(row0 + r) * D + d0 + c : src;
    if (VEC)
      gmt_cp_async16_ca(dst + r * VQ_LD + c, p, ok);
    else
      gmt_cp_async4(dst + r * VQ_LD + c, p, ok);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(VQ_THREADS, VQ_MINB)
    vq_one_hot_kernel(const float* __restrict__ z, const float* __restrict__ e,
                      float* __restrict__ one_hot, long long* __restrict__ idx_out, int N, int K,
                      int D) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int cand_k[VQ_WN][VQ_ROWS];  // each warp's (best key, index) of each row
  __shared__ int cand_i[VQ_WN][VQ_ROWS];
  __shared__ int sidx[VQ_ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / VQ_WN, wn = warp % VQ_WN;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * VQ_ROWS;
  const int n_dc = (D + VQ_DC - 1) / VQ_DC;
  const int stages = (K + VQ_KT - 1) / VQ_KT * n_dc;  // (K-tile, D-chunk), K-tile major
  const VqRing ring(stages, n_dc);
  float* zs = smem;                              // [zbuf][VQ_ROWS][VQ_LD]: the z chunks
  float* es = smem + ring.zbuf * VQ_ROWS * VQ_LD;  // [nbuf][VQ_KT][VQ_LD]: the codebook chunks

  // stage s's chunks into buffer s % nbuf (z only at s = 0 when D is one
  // chunk); one commit group a stage, empty past the last
  auto issue = [&](int s) {
    if (s < stages) {
      const int kt = s / n_dc, d0 = (s - kt * n_dc) * VQ_DC, b = s % ring.nbuf;
      if (n_dc > 1 || s == 0)
        vq_load<VQ_ROWS, VEC>(zs + (n_dc > 1 ? b : 0) * VQ_ROWS * VQ_LD, z, r0, N, d0, D, tid);
      vq_load<VQ_KT, VEC>(es + b * VQ_KT * VQ_LD, e, kt * VQ_KT, K, d0, D, tid);
    }
    gmt_cp_async_commit();
  };

  unsigned ahi[VQ_KS][4], alo[VQ_KS][4];  // the strip's A fragments of the chunk
  // lo.hi, hi.lo and hi.hi of each n8 tile: six independent mma chains
  float acc_lh[VQ_NT][4], acc_hl[VQ_NT][4], acc_hh[VQ_NT][4];
  float nrm[VQ_NT];  // this lane's part of |e|^2 of code g of each n8 tile
  int bk[2] = {INT_MAX, INT_MAX}, bi[2] = {INT_MAX, INT_MAX};  // rows g, g + 8

  for (int s = 0; s < VQ_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < stages; ++s) {
    gmt_cp_async_wait<VQ_STAGES - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and stage s - 1's buffer is read
    issue(s + VQ_STAGES - 1);
    const int kt = s / n_dc, dc = s - kt * n_dc, b = s % ring.nbuf;
    if (n_dc > 1 || s == 0) {
      const float* zb = zs + (n_dc > 1 ? b : 0) * VQ_ROWS * VQ_LD + (wm * 16 + g) * VQ_LD + t;
#pragma unroll
      for (int ks = 0; ks < VQ_KS; ++ks) {
        const float* p = zb + ks * 8;
        gmt_tf32_split(p[0], ahi[ks][0], alo[ks][0]);
        gmt_tf32_split(p[8 * VQ_LD], ahi[ks][1], alo[ks][1]);
        gmt_tf32_split(p[4], ahi[ks][2], alo[ks][2]);
        gmt_tf32_split(p[8 * VQ_LD + 4], ahi[ks][3], alo[ks][3]);
      }
    }
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < VQ_NT; ++j) {
        nrm[j] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_lh[j][q] = acc_hl[j][q] = acc_hh[j][q] = 0.f;
      }
    }
    const float* eb = es + b * VQ_KT * VQ_LD + (wn * VQ_CW + g) * VQ_LD + t;
#pragma unroll
    for (int ks = 0; ks < VQ_KS; ++ks) {  // every k8 step: the chunk is zero past D
#pragma unroll
      for (int j = 0; j < VQ_NT; ++j) {
        const float b0 = eb[j * 8 * VQ_LD + ks * 8], b1 = eb[j * 8 * VQ_LD + ks * 8 + 4];
        nrm[j] += b0 * b0 + b1 * b1;
        unsigned h0, l0, h1, l1;
        gmt_tf32_split(b0, h0, l0);
        gmt_tf32_split(b1, h1, l1);
        gmt_mma_tf32(acc_lh[j], alo[ks], h0, h1);
        gmt_mma_tf32(acc_hl[j], ahi[ks], l0, l1);
        gmt_mma_tf32(acc_hh[j], ahi[ks], h0, h1);
      }
    }
    if (dc == n_dc - 1) {  // the K-tile's scores: lane (g, t) holds codes 2t, 2t+1 of rows g, g+8
#pragma unroll
      for (int j = 0; j < VQ_NT; ++j) {
        float n = nrm[j];
        n += __shfl_xor_sync(0xffffffffu, n, 1);
        n += __shfl_xor_sync(0xffffffffu, n, 2);  // |e|^2 of code g, in quad g
        const float en[2] = {__shfl_sync(0xffffffffu, n, 8 * t),
                             __shfl_sync(0xffffffffu, n, 8 * t + 4)};
        const int c0 = kt * VQ_KT + wn * VQ_CW + j * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int code = c0 + (q & 1), h = q >> 1;
          // the small products first, then hi.hi
          const float dot = acc_hh[j][q] + (acc_lh[j][q] + acc_hl[j][q]);
          const int key = vq_key(-2.f * dot + en[q & 1]);
          if (code < K && key < bk[h]) {  // ascending codes: a tie keeps the first
            bk[h] = key;
            bi[h] = code;
          }
        }
      }
    }
  }

  // the four lanes of a row, then the strip's VQ_WN warps in order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int k = __shfl_xor_sync(0xffffffffu, bk[h], off);
      const int i = __shfl_xor_sync(0xffffffffu, bi[h], off);
      if (vq_better(k, i, bk[h], bi[h])) {
        bk[h] = k;
        bi[h] = i;
      }
    }
    if (t == 0) {
      cand_k[wn][wm * 16 + g + 8 * h] = bk[h];
      cand_i[wn][wm * 16 + g + 8 * h] = bi[h];
    }
  }
  __syncthreads();
  if (tid < VQ_ROWS) {
    int k = cand_k[0][tid], i = cand_i[0][tid];  // code 0 is warp 0's: every row has one
#pragma unroll
    for (int w = 1; w < VQ_WN; ++w) {
      if (vq_better(cand_k[w][tid], cand_i[w][tid], k, i)) {
        k = cand_k[w][tid];
        i = cand_i[w][tid];
      }
    }
    sidx[tid] = i;
  }
  __syncthreads();

  const int rows = min(VQ_ROWS, N - r0);
  if (tid < rows) idx_out[r0 + tid] = sidx[tid];
  // the block's rows are one run of rows * K floats, 16-byte aligned (r0 is
  // a multiple of 16); float4 v covers elements 4v..4v+3
  float* out = one_hot + (size_t)r0 * K;
  const long long n = (long long)rows * K, n4 = n >> 2;
  const int step_r = 4 * VQ_THREADS / K, step_c = 4 * VQ_THREADS - step_r * K;
  int r = 4 * tid / K, c = 4 * tid - r * K;  // (row, code) of element 4v
  for (long long v = tid; v < n4; v += VQ_THREADS) {
    float o[4];
    int rr = r, cc = c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[q] = cc == sidx[rr] ? 1.f : 0.f;
      if (++cc == K) {
        cc = 0;
        ++rr;
      }
    }
    reinterpret_cast<float4*>(out)[v] = make_float4(o[0], o[1], o[2], o[3]);
    r += step_r;
    c += step_c;
    if (c >= K) {
      c -= K;
      ++r;
    }
  }
  if (tid < (int)(n - 4 * n4)) {  // the last n % 4 elements, counted back from (rows-1, K-1)
    int rr = rows - 1, cc = K - 1 - tid;
    while (cc < 0) {
      cc += K;
      --rr;
    }
    out[n - 1 - tid] = cc == sidx[rr] ? 1.f : 0.f;
  }
}

template <bool VEC>
static cudaError_t vq_launch(const float* z, const float* e, float* one_hot, long long* idx,
                             int N, int K, int D, cudaStream_t stream) {
  const int n_dc = (D + VQ_DC - 1) / VQ_DC;
  const size_t smem = VqRing((K + VQ_KT - 1) / VQ_KT * n_dc, n_dc).floats() * sizeof(float);
  cudaError_t err = gmt_allow_smem(vq_one_hot_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  vq_one_hot_kernel<VEC><<<(N + VQ_ROWS - 1) / VQ_ROWS, VQ_THREADS, smem, stream>>>(
      z, e, one_hot, idx, N, K, D);
  return cudaGetLastError();
}

// z (N, D), e (K, D) f32 row-major -> one_hot (N, K) f32 (16-byte aligned),
// idx (N,) int64
extern "C" int gmt_vq_one_hot(const float* z, const float* e, float* one_hot, long long* idx,
                              int N, int K, int D, cudaStream_t stream) {
  if (N <= 0 || K <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (!gmt_aligned16(one_hot)) return cudaErrorMisalignedAddress;
  // 16-byte copies where every row starts 16-byte aligned, else 4-byte ones
  const bool vec = D % 4 == 0 && gmt_aligned16(z) && gmt_aligned16(e);
  return vec ? vq_launch<true>(z, e, one_hot, idx, N, K, D, stream)
             : vq_launch<false>(z, e, one_hot, idx, N, K, D, stream);
}
