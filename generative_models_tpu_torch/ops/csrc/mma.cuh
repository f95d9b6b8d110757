// Tensor-core and copy helpers shared by the port's kernels, for sm_90a:
// cp.async (global -> shared, 16 or 4 bytes, zero-filled when out of range),
// ldmatrix (8x8 b16 tiles from shared memory into mma fragments),
// mma.sync m16n8k16 on bf16 with f32 accumulation and mma.sync m16n8k32 on
// s8 with s32 accumulation.
//
// Fragments of mma.m16n8k16.row.col (lane l of the warp, g = l / 4,
// c = 2 * (l % 4)):
//   A (16 x 16, row-major)  a[0]: (g, c..c+1)  a[1]: (g+8, c..c+1)
//                           a[2]: (g, c+8..)   a[3]: (g+8, c+8..)
//   B (16 x 8, k x n)       b[0]: (k c..c+1, n g)  b[1]: (k c+8.., n g)
//   C, D (16 x 8, f32)      d[0..1]: (g, c..c+1)   d[2..3]: (g+8, c..c+1)
// Each 32-bit register holds two bf16, the lower k (or column) in the low
// half.
//
// Fragments of mma.m16n8k32.row.col s8 (g, t = l % 4): each register holds
// four s8 of consecutive k, the lowest k in the low byte:
//   A (16 x 32, row-major)  a[0]: (g, 4t..4t+3)   a[1]: (g+8, 4t..)
//                           a[2]: (g, 16+4t..)    a[3]: (g+8, 16+4t..)
//   B (32 x 8, k x n)       b[0]: (k 4t..4t+3, n g)  b[1]: (k 16+4t.., n g)
//   C, D (16 x 8, s32)      as the f32 accumulator above
// so ldmatrix (non-.trans) gives A from an (m, k) byte tile and B from an
// (n, k) byte tile, an 8x8 b16 matrix being 8 rows of 16 k.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

__device__ __forceinline__ unsigned gmt_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; when !pred, nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void gmt_cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(gmt_smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously, zero-filled when !pred (for
// f32 rows that are not 16-byte aligned)
__device__ __forceinline__ void gmt_cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(gmt_smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void gmt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void gmt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[i] receives matrix i's (row l / 4, columns 2 (l % 4) ..+1)
__device__ __forceinline__ void gmt_ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(gmt_smem_addr(p)));
}

// the same, each matrix transposed: r[i] receives matrix i's (rows 2 (l % 4)
// ..+1, column l / 4), the B fragment of a tile stored (k, n)
__device__ __forceinline__ void gmt_ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(gmt_smem_addr(p)));
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), f32 sums
__device__ __forceinline__ void gmt_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32 s8) @ b (32 x 8 s8), s32 sums (exact: the caller keeps
// K * 127^2 within int32)
__device__ __forceinline__ void gmt_mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                           unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (to nearest, ties to even) in one register, lo in
// the low half
__device__ __forceinline__ unsigned gmt_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
