// Shared helpers of the boxtree_torch CUDA kernels.
//
// Every C entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError(); the Python wrapper
// (boxtree_torch/ops/kernels.py) raises on a non-zero code.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace boxtree_torch {

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return ::floor(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace boxtree_torch
