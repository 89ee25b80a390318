// Dual numbers: forward-mode derivatives inside the dipole kernels.
//
// Dual<T> carries a value and a tangent through + - * /, products and
// quotients by a constant, sqrt_t, log_t, atan2_t and sincos_t: run on it,
// a recurrence computes its own directional derivative, the JVP the
// reference takes of its hooks (boxtree_tpu/models/expansion_base.py:
// 664-673, :1314-1324, :1688-1694).  Each operation's tangent is the one
// JAX's JVP rule takes: d(a / b) = (da - (a / b) db) / b, d log a = da / a,
// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2), d sin a = cos a da, d cos a
// = -sin a da.  value_of(x) is the value a branch tests (x itself for a
// float): a branch on it takes the tangent of the side it picks, as
// jnp.where does.  with_tangent(a, slope, t) replaces a's tangent by
// slope dt, where a formula's own tangent loses digits (bessel.cuh's j_0).
//
// Cx<S> is a complex number over a scalar S (T or Dual<T>) with the
// products the 2D kernels take: mul, inv (1 / z), and log_c (log |z|, arg
// z).  On Cx<Dual<T>> the tangent of inv is -dz / z^2 and that of log_c is
// dz / z, JAX's rules for 1 / z and log z.
//
// Users: the 3D Laplace dipole kernels K22, K23, K29 (laplace3d.cuh), the
// 2D ones K39, K41, K42 (laplace2d.cu) and the 3D Helmholtz ones K57-K62
// (helmholtz3d.cu, through bessel.cuh's recurrences).
#pragma once

#include "common.cuh"

namespace boxtree_torch {

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return ::log(x); }
__device__ __forceinline__ float atan2_t(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double atan2_t(double y, double x) {
  return ::atan2(y, x);
}
__device__ __forceinline__ double sin_t(double x) { return ::sin(x); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  ::sincos(x, s, c);
}
__device__ __forceinline__ float value_of(float x) { return x; }
__device__ __forceinline__ double value_of(double x) { return x; }
// a with its tangent set to slope dt (a itself for a float): for a value
// whose own formula's tangent cancels, where the caller knows the
// derivative in another form
__device__ __forceinline__ double with_tangent(double a, double, double) {
  return a;
}

template <typename T>
struct Dual {
  T v, d;  // value, tangent
  __device__ __forceinline__ Dual() : v(0), d(0) {}
  __device__ __forceinline__ Dual(T value, T tangent)
      : v(value), d(tangent) {}
  // a constant of the recurrences, T(2 * m - 1) and the like
  __device__ __forceinline__ explicit Dual(int c) : v(T(c)), d(T(0)) {}
  __device__ __forceinline__ explicit Dual(T c) : v(c), d(T(0)) {}
};

template <typename T>
__device__ __forceinline__ T value_of(Dual<T> a) {
  return a.v;
}

template <typename T>
__device__ __forceinline__ Dual<T> with_tangent(Dual<T> a, T slope,
                                                Dual<T> t) {
  return Dual<T>(a.v, slope * t.d);
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return Dual<T>(-a.v, -a.d);
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
// products and quotients by a constant c: d(c a) = c da, d(a / c) = da / c
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T c, Dual<T> a) {
  return Dual<T>(c * a.v, c * a.d);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T c) {
  return Dual<T>(a.v * c, a.d * c);
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) {
  return Dual<T>(a.v / c, a.d / c);
}
template <typename T>
__device__ __forceinline__ Dual<T> sqrt_t(Dual<T> a) {
  const T s = sqrt_t(a.v);
  return Dual<T>(s, a.d / (T(2) * s));
}
template <typename T>
__device__ __forceinline__ Dual<T> log_t(Dual<T> a) {
  return Dual<T>(log_t(a.v), a.d / a.v);
}
template <typename T>
__device__ __forceinline__ Dual<T> atan2_t(Dual<T> y, Dual<T> x) {
  return Dual<T>(atan2_t(y.v, x.v),
                 (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}

template <typename T>
__device__ __forceinline__ Dual<T> sin_t(Dual<T> a) {
  return Dual<T>(sin_t(a.v), cos(a.v) * a.d);
}
template <typename T>
__device__ __forceinline__ void sincos_t(Dual<T> a, Dual<T>* s,
                                         Dual<T>* c) {
  T sv, cv;
  sincos_t(a.v, &sv, &cv);
  *s = Dual<T>(sv, cv * a.d);
  *c = Dual<T>(cv, -(sv * a.d));
}

template <typename S>
struct Cx {
  S re, im;
};

template <typename S>
__device__ __forceinline__ Cx<S> mul(Cx<S> a, Cx<S> b) {
  return Cx<S>{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// 1 / z
template <typename T>
__device__ __forceinline__ Cx<T> inv(Cx<T> z) {
  const T d = z.re * z.re + z.im * z.im;
  return Cx<T>{z.re / d, -z.im / d};
}
template <typename T>
__device__ __forceinline__ Cx<Dual<T>> inv(Cx<Dual<T>> z) {
  const Cx<T> w = inv(Cx<T>{z.re.v, z.im.v});
  const Cx<T> w2 = mul(w, w);
  // -dz / z^2
  const Cx<T> t = mul(Cx<T>{-z.re.d, -z.im.d}, w2);
  return Cx<Dual<T>>{Dual<T>(w.re, t.re), Dual<T>(w.im, t.im)};
}

// log z = (log |z|, arg z), the argument honouring a signed zero
template <typename T>
__device__ __forceinline__ Cx<T> log_c(Cx<T> z) {
  return Cx<T>{log_t(hypot(z.re, z.im)), atan2_t(z.im, z.re)};
}
template <typename T>
__device__ __forceinline__ Cx<Dual<T>> log_c(Cx<Dual<T>> z) {
  const Cx<T> zv{z.re.v, z.im.v};
  const Cx<T> l = log_c(zv);
  // dz / z
  const Cx<T> t = mul(Cx<T>{z.re.d, z.im.d}, inv(zv));
  return Cx<Dual<T>>{Dual<T>(l.re, t.re), Dual<T>(l.im, t.im)};
}

}  // namespace boxtree_torch
