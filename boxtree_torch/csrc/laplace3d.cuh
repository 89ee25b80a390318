// Value types and dual numbers of the 3D Laplace list kernels (K2-K4 and
// the dipole kernels K22, K23).
//
// Charges, multipoles and potentials are of a value type V: the geometry's
// float type T for the real-pair entry points (_f32, _f64), double2 for
// complex128 (_c128, interleaved re, im, over float64 geometry).
//
// Dual<T> carries a value and a tangent through + - * / and sqrt_t: run on
// it, a recurrence computes its own directional derivative, the forward-mode
// JVP the reference takes of its hooks (boxtree_tpu/models/
// expansion_base.py:1688-1694).  K23 runs harmonics.cuh's
// irregular_pairs_foreach on Dual<T> as it is.
#pragma once

#include <type_traits>

#include "common.cuh"

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

template <typename T>
struct Dual {
  T v, d;  // value, tangent
  __device__ __forceinline__ Dual() : v(0), d(0) {}
  __device__ __forceinline__ Dual(T value, T tangent)
      : v(value), d(tangent) {}
  // a constant of the recurrences, T(2 * m - 1) and the like
  __device__ __forceinline__ explicit Dual(int c) : v(T(c)), d(T(0)) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> sqrt_t(Dual<T> a) {
  const T s = sqrt_t(a.v);
  return Dual<T>(s, a.d / (T(2) * s));
}

}  // namespace boxtree_torch
