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
#pragma once

#include "common.cuh"

namespace boxtree_torch {

constexpr int kJnExtra = 25;
constexpr double kJnSmallX = 1e-6;
constexpr double kJnDenomFloor = 1e-300;

__device__ __forceinline__ void spherical_jn(double x, int p, double* out,
                                             int stride) {
  if (fabs(x) < kJnSmallX) {
    double xn = 1.0, dfact = 1.0;
    for (int n = 0; n <= p; ++n) {
      if (n > 0) {
        xn *= x;
        dfact *= double(2 * n + 1);
      }
      out[n * stride] = xn / dfact;
    }
    return;
  }
  const double xinv = 1.0 / x;
  const int nstart = p + kJnExtra;
  double r = x / double(2 * nstart + 3);
  for (int n = nstart; n > 0; --n) {
    double denom = double(2 * n + 1) * xinv - r;
    if (fabs(denom) < kJnDenomFloor) denom = kJnDenomFloor;
    r = 1.0 / denom;
    if (n <= p) out[n * stride] = r;
  }
  double j = sin(x) * xinv;
  out[0] = j;
  for (int n = 1; n <= p; ++n) {
    j *= out[n * stride];
    out[n * stride] = j;
  }
}

__device__ __forceinline__ void spherical_yn(double x, int p, double* out,
                                             int stride) {
  const double xs = x == 0.0 ? 1.0 : x;
  const double xinv = 1.0 / xs;
  double sn, cs;
  sincos(xs, &sn, &cs);
  double y0 = -cs * xinv;
  out[0] = y0;
  if (p < 1) return;
  double y1 = (-cs * xinv - sn) * xinv;
  out[stride] = y1;
  for (int n = 1; n < p; ++n) {
    const double y2 = double(2 * n + 1) * xinv * y1 - y0;
    out[(n + 1) * stride] = y2;
    y0 = y1;
    y1 = y2;
  }
}

// h^(1)_n(x) s^n = (j_n(x) + i y_n(x)) s^n for n = 0..p into out[n * stride]
// (the radial factor of the rscaled outgoing basis).
__device__ __forceinline__ void spherical_hn1_scaled(double x, double s,
                                                     int p, double2* out,
                                                     int stride) {
  double* re = reinterpret_cast<double*>(out);
  spherical_jn(x, p, re, 2 * stride);
  spherical_yn(x, p, re + 1, 2 * stride);
  double pw = 1.0;
  for (int n = 1; n <= p; ++n) {
    pw *= s;
    out[n * stride].x *= pw;
    out[n * stride].y *= pw;
  }
}

}  // namespace boxtree_torch
