// Spherical Bessel functions j_n, y_n (n = 0..p) in double precision, for
// the Helmholtz M2P (K10) and P2L (K11) kernels.
//
// The recurrences of boxtree_tpu/ops/spherical_bessel.py:29-78 and of their
// plain twins (boxtree_torch/ops/spherical_bessel.py), with the same order
// of operations and the same branch points, so that the kernels and the
// twins agree to rounding:
//   j_n: downward ratio recurrence r_n = j_n / j_{n-1}
//        = 1 / ((2n+1)/x - r_{n+1}) from nstart = p + 25, seeded with
//        x / (2 nstart + 3), denominators below 1e-300 in magnitude set to
//        1e-300; then j_n = j_0 r_1 ... r_n with j_0 = sin(x)/x.  Below
//        |x| < 1e-6, the leading series term x^n / (2n+1)!!.
//   y_n: upward y_{n+1} = (2n+1)/x y_n - y_{n-1} from y_0 = -cos(x)/x,
//        y_1 = (-cos(x)/x - sin(x))/x; not valid at x = 0 (callers guard).
// Values go to out[n * stride], so a caller can lay them out in shared
// memory one thread per column.
//
// T is double, or Dual<double> (dual.cuh) for the dipole kernels K57-K62,
// which take the recurrences' tangents as JAX's jvp takes them: a branch
// tests the value and takes the tangent of the side it picks (the series
// x^n / (2n+1)!! below 1e-6, its tangent n x^(n-1) / (2n+1)!! dx by the
// product rule); a floored denominator and y_n's x = 0 guard are constants
// with zero tangent.  One tangent differs from JAX's: j_0's is -j_1 dx =
// -j_0 r_1 dx, where the tangent of sin(x) / x, cos x / x - sin x / x^2,
// cancels to eps / x^2 of itself (2e-12 at the k r = 0.007 of a 9-level
// tree's leaves, the dipole P2M's n = 0 column).  The double
// instantiations run the operations of the functions before they were
// templates, in the same order.
#pragma once

#include "common.cuh"
#include "dual.cuh"

namespace boxtree_torch {

constexpr int kJnExtra = 25;
constexpr double kJnSmallX = 1e-6;
constexpr double kJnDenomFloor = 1e-300;

template <typename T>
__device__ __forceinline__ void spherical_jn(T x, int p, T* out, int stride) {
  if (fabs(value_of(x)) < kJnSmallX) {
    T xn = T(1);
    double dfact = 1.0;
    for (int n = 0; n <= p; ++n) {
      if (n > 0) {
        xn = xn * x;
        dfact *= double(2 * n + 1);
      }
      out[n * stride] = xn / dfact;
    }
    return;
  }
  const T xinv = T(1) / x;
  const int nstart = p + kJnExtra;
  T r = x / double(2 * nstart + 3);
  for (int n = nstart; n > 0; --n) {
    T denom = double(2 * n + 1) * xinv - r;
    if (fabs(value_of(denom)) < kJnDenomFloor) denom = T(kJnDenomFloor);
    r = T(1) / denom;
    if (n <= p) out[n * stride] = r;
  }
  T j = sin_t(x) * xinv;
  j = with_tangent(j, -(value_of(j) * value_of(r)), x);  // r holds r_1
  out[0] = j;
  for (int n = 1; n <= p; ++n) {
    j = j * out[n * stride];
    out[n * stride] = j;
  }
}

template <typename T>
__device__ __forceinline__ void spherical_yn(T x, int p, T* out, int stride) {
  const T xs = value_of(x) == 0.0 ? T(1) : x;
  const T xinv = T(1) / xs;
  T sn, cs;
  sincos_t(xs, &sn, &cs);
  T y0 = -cs * xinv;
  out[0] = y0;
  if (p < 1) return;
  T y1 = (-cs * xinv - sn) * xinv;
  out[stride] = y1;
  for (int n = 1; n < p; ++n) {
    const T y2 = double(2 * n + 1) * xinv * y1 - y0;
    out[(n + 1) * stride] = y2;
    y0 = y1;
    y1 = y2;
  }
}

// h^(1)_n(x) s^n = (j_n(x) + i y_n(x)) s^n for n = 0..p into out[n * stride]
// (the radial factor of the rscaled outgoing basis): C is a (re, im) pair
// of T, double2 for T = double, Cx<Dual<double>> for the dipole kernels.
template <typename T, typename C>
__device__ __forceinline__ void spherical_hn1_scaled(T x, double s, int p,
                                                     C* out, int stride) {
  static_assert(sizeof(C) == 2 * sizeof(T), "C is a (re, im) pair of T");
  T* re = reinterpret_cast<T*>(out);
  spherical_jn(x, p, re, 2 * stride);
  spherical_yn(x, p, re + 1, 2 * stride);
  double pw = 1.0;
  for (int n = 1; n <= p; ++n) {
    pw *= s;
    re[2 * n * stride] = re[2 * n * stride] * pw;
    re[2 * n * stride + 1] = re[2 * n * stride + 1] * pw;
  }
}

}  // namespace boxtree_torch
