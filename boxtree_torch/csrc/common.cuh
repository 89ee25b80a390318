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

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return ::sqrt(x); }

__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return ::floor(x); }

// IEEE operations rounded to nearest that the compiler never contracts
// into an FMA: kernels whose results must equal a plain version bit for
// bit spell their float steps with these
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// Above the default 48 KiB a kernel's dynamic shared memory needs its
// opt-in (up to 227 KiB a CTA on sm_90).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace boxtree_torch
