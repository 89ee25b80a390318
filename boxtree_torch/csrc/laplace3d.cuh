// Value types and dual numbers of the 3D Laplace list kernels (K2-K4 and
// the dipole kernels K22, K23).
//
// Charges, multipoles and potentials are of a value type V: the geometry's
// float type T for the real-pair entry points (_f32, _f64), double2 for
// complex128 (_c128, interleaved re, im, over float64 geometry).
//
// The dipole kernels run the recurrences on dual.cuh's Dual<T>: K23 runs
// harmonics.cuh's irregular_pairs_foreach on Dual<T> as it is.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "dual.cuh"

namespace boxtree_torch {

template <typename V>
constexpr bool kIsComplex = std::is_same<V, double2>::value;

template <typename V>
__device__ __forceinline__ V val_zero() {
  return V(0);
}
template <>
__device__ __forceinline__ double2 val_zero<double2>() {
  return make_double2(0.0, 0.0);
}

// acc += g q with a real factor g
template <typename T>
__device__ __forceinline__ void val_axpy(T& acc, T g, T q) {
  acc += g * q;
}
__device__ __forceinline__ void val_axpy(double2& acc, double g, double2 q) {
  acc.x += g * q.x;
  acc.y += g * q.y;
}

}  // namespace boxtree_torch
