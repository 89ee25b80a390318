// Morton-key bit layout shared by the kernels: the level-l digit of a key
// occupies bits [d*(D-l), d*(D-l+1)), and within each d-bit digit axis 0
// (x) holds the most significant bit (boxtree_tpu/ops/morton.py:20-100).
#pragma once

#include <cstdint>

namespace boxtree_torch {

__device__ __forceinline__ uint64_t spread_bits(uint64_t x, int d) {
  // the _SPREAD2_MASKS / _SPREAD3_MASKS of boxtree_tpu/ops/morton.py:20-34
  if (d == 2) {
    x &= 0xFFFFFFFFull;
    x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
    x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x << 2)) & 0x3333333333333333ull;
    x = (x | (x << 1)) & 0x5555555555555555ull;
  } else if (d == 3) {
    x &= 0x1FFFFFull;
    x = (x | (x << 32)) & 0x001F00000000FFFFull;
    x = (x | (x << 16)) & 0x001F0000FF0000FFull;
    x = (x | (x << 8)) & 0x100F00F00F00F00Full;
    x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
    x = (x | (x << 2)) & 0x1249249249249249ull;
  }
  return x;
}

// inverse of spread_bits (boxtree_tpu/ops/morton.py _compact)
__device__ __forceinline__ uint64_t compact_bits(uint64_t x, int d) {
  if (d == 2) {
    x &= 0x5555555555555555ull;
    x = (x | (x >> 1)) & 0x3333333333333333ull;
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
    x = (x | (x >> 16)) & 0xFFFFFFFFull;
  } else if (d == 3) {
    x &= 0x1249249249249249ull;
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3ull;
    x = (x | (x >> 4)) & 0x100F00F00F00F00Full;
    x = (x | (x >> 8)) & 0x001F0000FF0000FFull;
    x = (x | (x >> 16)) & 0x001F00000000FFFFull;
    x = (x | (x >> 32)) & 0x1FFFFFull;
  }
  return x;
}

// cells[0..d) (non-negative, in range) -> Morton key
__device__ __forceinline__ int64_t interleave_cells(const int64_t* cells,
                                                    int d) {
  uint64_t code = 0;
  for (int ax = 0; ax < d; ++ax)
    code |= spread_bits((uint64_t)cells[ax], d) << (d - 1 - ax);
  return (int64_t)code;
}

// Morton key (non-negative) -> cells[0..d)
__device__ __forceinline__ void deinterleave_code(int64_t code, int d,
                                                  int64_t* cells) {
  const uint64_t axis_mask =
      d == 2 ? 0x5555555555555555ull
             : (d == 3 ? 0x1249249249249249ull : ~0ull);
  for (int ax = 0; ax < d; ++ax)
    cells[ax] = (int64_t)compact_bits(
        ((uint64_t)code >> (d - 1 - ax)) & axis_mask, d);
}

// first index in the ascending keys[0..n) with keys[i] >= key
// (searchsorted, side='left')
__device__ __forceinline__ long long lower_bound_i64(const int64_t* keys,
                                                     long long n,
                                                     int64_t key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

}  // namespace boxtree_torch
