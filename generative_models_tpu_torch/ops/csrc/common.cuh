// Helpers shared by the port's kernels (included once per library).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define GMT_NEG_INF (-1e30f)  // the JAX package's NEG_INF: finite, so no inf-inf NaNs

// round an f32 to the nearest bf16 and back: the "bf16 operand" of a product
// whose accumulation stays f32
__device__ __forceinline__ float gmt_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gmt_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm of `rows` rows of width C (src row stride C), one warp per row,
// as the JAX package's _ln: two-pass mean and variance, eps 1e-6, then
// * scale + bias. Rows at or past `valid` are written as zeros. The result is
// rounded to bf16, the operand type of the product that follows.
__device__ __forceinline__ void gmt_layernorm_rows_bf16(
    const float* src, const float* scale, const float* bias, float* dst,
    int rows, int valid, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const float* xr = src + (size_t)r * C;
    float* hr = dst + (size_t)r * C;
    if (r >= valid) {
      for (int c = lane; c < C; c += 32) hr[c] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mean = gmt_warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      v += d * d;
    }
    const float rs = rsqrtf(gmt_warp_sum(v) / C + 1e-6f);
    for (int c = lane; c < C; c += 32)
      hr[c] = gmt_round_bf16((xr[c] - mean) * rs * scale[c] + bias[c]);
  }
}

// Raise the dynamic shared memory cap of a kernel when it asks for more than
// the default 48 KB (the wrappers refuse sizes past the card's 227 KB).
template <typename K>
__host__ inline cudaError_t gmt_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
