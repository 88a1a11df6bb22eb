// Shared helpers of the port's CUDA kernels. Every entry point is a plain
// C function that launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once
#include <cuda_runtime.h>

#define K2_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t k2_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ float k2_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
