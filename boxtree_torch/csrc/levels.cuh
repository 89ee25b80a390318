// Searches over sorted Morton keys and the per-block level histogram,
// shared by the tree build's kernels (tree.cu, K43-K46) and the sharded
// build's (shard.cu, K87 and K88).
#pragma once

#include <cstdint>

namespace boxtree_torch {

// levels 0..depth (62 in 1D) and the empty level depth + 1
constexpr int kMaxLevels = 64;

// first index in [lo, hi) of the ascending keys with keys[i] >= key, else hi
__device__ __forceinline__ long long lower_bound_in(const int64_t* keys,
                                                    long long lo,
                                                    long long hi,
                                                    int64_t key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// first index in [lo, hi) of the ascending values with v[i] > x, else hi
template <typename T>
__device__ __forceinline__ long long upper_bound_in(const T* v, long long lo,
                                                    long long hi, T x) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (v[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// deepest level at which key cur shares its prefix with key prev (at
// least -1), boxtree_tpu/tree/build.py:321-326
__device__ __forceinline__ int lcp_of(int64_t prev, int64_t cur, int d,
                                      int depth) {
  const int64_t x = cur ^ prev;
  const int bl = x < 0 ? 64 : 64 - __clzll(x);
  const int lcp = depth - (bl + d - 1) / d;
  return lcp < -1 ? -1 : lcp;
}

// the same for particle i and i - 1 (-1 for the first particle)
__device__ __forceinline__ int lcp_level(const int64_t* codes, long long i,
                                         int d, int depth) {
  return i == 0 ? -1 : lcp_of(codes[i - 1], codes[i], d, depth);
}

// the per-block level histogram: counts of ranges (a, b] of levels
struct LevelHistogram {
  int* diff;  // kMaxLevels + 1 entries of shared memory

  __device__ void clear() {
    for (int l = threadIdx.x; l <= kMaxLevels; l += blockDim.x) diff[l] = 0;
  }
  __device__ void add_range(int a, int b) {  // levels a + 1 .. b
    if (b <= a) return;
    atomicAdd(&diff[a + 1], 1);
    atomicAdd(&diff[b + 1], -1);
  }
  // after a __syncthreads(): this block's counts added to out[0..nlev)
  __device__ void flush(unsigned long long* out, int nlev) {
    if (threadIdx.x == 0) {
      int run = 0;
      for (int l = 0; l < nlev; ++l) {
        run += diff[l];
        diff[l] = run;
      }
    }
    __syncthreads();
    for (int l = threadIdx.x; l < nlev; l += blockDim.x)
      if (diff[l]) atomicAdd(&out[l], (unsigned long long)diff[l]);
  }
};

}  // namespace boxtree_torch
