// Cylindrical Hankel functions H_n = J_n + i Y_n (n = 0..p) in double
// precision at one argument, for the 2D Helmholtz M2P (K17) and P2L (K18)
// kernels.
//
// The recurrences of boxtree_tpu/ops/cylinder_bessel.py:38-110 and of their
// plain twin (boxtree_torch/ops/cylinder_bessel.py), with the same steps,
// order of operations and branch points, so that the kernels and the twins
// agree to rounding:
//   J_n: downward ratio recurrence r_n = J_n / J_{n-1} = 1 / (2n/x -
//        r_{n+1}) from the even order nstart (the wrapper's even_start:
//        >= p + 2, >= 3), seeded with x / (2 (nstart + 1)), denominators
//        below 1e-300 in magnitude set to +-1e-300; then the products
//        P_n = J_n / J_0 = r_1 ... r_n and the Neumann normalisation
//        J_0 = 1 / (1 + 2 sum_k P_2k).  Below |x| < 1e-8, the leading
//        series term (x/2)^n / n!.
//   Y_0, Y_1: the log series in the P_n (Abramowitz & Stegun 9.1.88/89),
//        then the upward Y_{n+1} = (2n/x) Y_n - Y_{n-1}.  Below |x| < 1e-8
//        the upward recurrence starts from the leading small-argument terms
//        Y_0 = (2/pi)(log(x/2) + g) (J_0 = 1) and Y_1 = -2/(pi x), with the
//        true 1/x (the reference evaluates Y at x = 1 there); not valid at
//        x = 0 (callers mask r = 0).
// The recurrence runs in registers; the ratios, and then the products in
// their place, are parked in scratch[n * stride] (n = 0..nstart), because
// the products run upward after the downward sweep.  H_n goes to
// h[n * stride], so a caller can lay both out in shared memory one thread
// per column.
#pragma once

#include "common.cuh"

namespace boxtree_torch {

constexpr double kCylSmallX = 1e-8;
constexpr double kCylDenomFloor = 1e-300;
constexpr double kEulerGamma = 0.5772156649015328606;
constexpr double kTwoOverPi = 0.63661977236758134308;

__device__ __forceinline__ void cylindrical_h(double x, int p, int nstart,
                                              double* scratch, double2* h,
                                              int stride) {
  const bool small = fabs(x) < kCylSmallX;
  const double xs = small ? 1.0 : x;
  const double xinv = 1.0 / xs;

  double r = xs / (2.0 * (nstart + 1));  // asymptotic seed r_{nstart+1}
  for (int n = nstart; n > 0; --n) {
    double denom = 2.0 * n * xinv - r;
    if (fabs(denom) < kCylDenomFloor)
      denom = denom < 0.0 ? -kCylDenomFloor : kCylDenomFloor;
    r = 1.0 / denom;
    scratch[n * stride] = r;
  }
  double prod = 1.0;
  scratch[0] = 1.0;
  for (int n = 1; n <= nstart; ++n) {
    prod *= scratch[n * stride];
    scratch[n * stride] = prod;
  }

  double s_norm = 1.0, s_y0 = 0.0, s_y1 = 0.0;
  for (int k = 1; k <= nstart / 2; ++k) {
    const double w = ((k & 1) ? 1.0 : -1.0) / k;
    const double p2k = scratch[2 * k * stride];
    s_norm = s_norm + 2.0 * p2k;
    s_y0 = s_y0 + w * p2k;
    if (2 * k + 1 <= nstart)
      s_y1 = s_y1 + w * (scratch[(2 * k - 1) * stride] -
                         scratch[(2 * k + 1) * stride]);
  }
  const double j0 = 1.0 / s_norm;
  const double logterm = log(0.5 * xs) + kEulerGamma;
  double ya = kTwoOverPi * (logterm + 2.0 * s_y0) * j0;            // Y_0
  double yb = kTwoOverPi * (logterm * scratch[stride] - xinv - s_y1) * j0;
  double yinv = xinv;  // the 1/x of the upward Y recurrence
  if (small) {
    ya = kTwoOverPi * (log(0.5 * x) + kEulerGamma);
    yb = -kTwoOverPi / x;
    yinv = 1.0 / x;
  }

  double half_pow = 1.0, fact = 1.0;  // (x/2)^n, n!
  for (int n = 0; n <= p; ++n) {
    double j = scratch[n * stride] * j0;
    if (small) {
      if (n > 0) {
        half_pow *= x * 0.5;
        fact *= n;
      }
      j = half_pow / fact;
    }
    double y;
    if (n == 0) {
      y = ya;
    } else if (n == 1) {
      y = yb;
    } else {
      y = 2.0 * (n - 1) * yinv * yb - ya;
      ya = yb;
      yb = y;
    }
    h[n * stride] = make_double2(j, y);
  }
}

}  // namespace boxtree_torch
