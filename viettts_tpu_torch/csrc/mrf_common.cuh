// Pieces shared by the generator-stage kernels K2 (mrf.cu) and K3
// (mrf_int8.cu): the conv tile shape, storage-type conversions, leaky_relu
// and the opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace viettts {

constexpr int TL = 128;  // conv: output rows (time) per block
constexpr int TN = 32;   // conv: output channels per block
constexpr int NT = 256;  // conv: threads, 32 row groups x 8 column groups, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace viettts
