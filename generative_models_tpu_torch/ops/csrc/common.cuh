// Helpers shared by the port's kernels (included once per library).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Raise the dynamic shared memory cap of a kernel when it asks for more than
// the default 48 KB (the wrappers refuse sizes past the card's 227 KB).
template <typename K>
__host__ inline cudaError_t gmt_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__host__ inline bool gmt_aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
