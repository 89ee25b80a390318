// Cylindrical Bessel functions in double precision at one argument, for the
// 2D Helmholtz kernels: H_n = J_n + i Y_n (n = 0..p) for M2P (K17) and P2L
// (K18), J_n alone for P2M (K33) and L2P (K34).
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
// The ratios come from the top and the products run upward, so the nstart
// ratios are parked in scratch[(n - 1) * stride], n = 1..nstart: a column
// of a global buffer that one thread owns and reads back itself (it stays
// in L1 / L2).  The wrapper sizes that buffer by the grid it launches, not
// by shared memory, so no order or k r is refused for its sake.  The
// products, the Neumann sum and the two Y sums are formed in one upward
// pass, each sum over k in the twin's order; the products up to p go to the
// caller's table (shared memory, one column a thread), where J_n replaces
// them.  The recurrences are spelled with the operations of common.cuh
// that are never contracted into an FMA, as the twin's PyTorch operations
// are each rounded: near a zero of J_0 or at a large x the sums cancel,
// and a fused step would part the kernels from the twin there.
#pragma once

#include "common.cuh"

namespace boxtree_torch {

constexpr double kCylSmallX = 1e-8;
constexpr double kCylDenomFloor = 1e-300;
constexpr double kEulerGamma = 0.5772156649015328606;
constexpr double kTwoOverPi = 0.63661977236758134308;

// The downward sweep from nstart (x >= kCylSmallX, xinv = 1 / x): r_n into
// scratch[(n - 1) * stride].
__device__ __forceinline__ void cyl_ratios(double x, double xinv, int nstart,
                                           double* scratch,
                                           long long stride) {
  double r = x / (2.0 * (nstart + 1));  // asymptotic seed r_{nstart+1}
  for (int n = nstart; n > 0; --n) {
    double denom = sub_rn(mul_rn(2.0 * n, xinv), r);
    if (fabs(denom) < kCylDenomFloor)
      denom = denom < 0.0 ? -kCylDenomFloor : kCylDenomFloor;
    r = div_rn(1.0, denom);
    scratch[(n - 1) * stride] = r;
  }
}

// The upward pass over the ratios: P_n (n <= p) into pn[n * pstride], P_1
// into p1, the Neumann sum 1 + 2 sum_k P_2k into s_norm and, with kY, the Y
// log-series sums sum_k w_k P_2k and sum_k w_k (P_{2k-1} - P_{2k+1}), w_k =
// (-1)^{k+1} / k, into s_y0 and s_y1.
template <bool kY>
__device__ __forceinline__ void cyl_products(int p, int nstart,
                                             const double* scratch,
                                             long long stride, double* pn,
                                             int pstride, double& p1,
                                             double& s_norm, double& s_y0,
                                             double& s_y1) {
  double prod = 1.0, prev_odd = 0.0;
  pn[0] = 1.0;
  p1 = 0.0;
  s_norm = 1.0;
  s_y0 = 0.0;
  s_y1 = 0.0;
  for (int n = 1; n <= nstart; ++n) {
    prod = mul_rn(prod, scratch[(n - 1) * stride]);
    if (n <= p) pn[n * pstride] = prod;
    if (n & 1) {
      if (n == 1) p1 = prod;
      if (kY && n >= 3) {
        const int k = (n - 1) / 2;
        s_y1 = add_rn(s_y1, mul_rn(((k & 1) ? 1.0 : -1.0) / k,
                                   sub_rn(prev_odd, prod)));
      }
      prev_odd = prod;
    } else {
      const int k = n / 2;
      s_norm = add_rn(s_norm, mul_rn(2.0, prod));
      if (kY) s_y0 = add_rn(s_y0, mul_rn(((k & 1) ? 1.0 : -1.0) / k, prod));
    }
  }
}

// (x/2)^n / n! for n = 0..p into out[n * stride], the series below the
// switch.
__device__ __forceinline__ void cyl_j_series(double x, int p, double* out,
                                             int stride) {
  double half_pow = 1.0, fact = 1.0;  // (x/2)^n, n!
  for (int n = 0; n <= p; ++n) {
    if (n > 0) {
      half_pow *= x * 0.5;
      fact *= n;
    }
    out[n * stride] = half_pow / fact;
  }
}

// J_n(x), n = 0..p, into j[n * jstride]; x = 0 gives [n == 0].
__device__ __forceinline__ void cylindrical_j(double x, int p, int nstart,
                                              double* scratch,
                                              long long stride, double* j,
                                              int jstride) {
  if (fabs(x) < kCylSmallX) {
    cyl_j_series(x, p, j, jstride);
    return;
  }
  cyl_ratios(x, 1.0 / x, nstart, scratch, stride);
  double p1, s_norm, s_y0, s_y1;
  cyl_products<false>(p, nstart, scratch, stride, j, jstride, p1, s_norm,
                      s_y0, s_y1);
  const double j0 = 1.0 / s_norm;
  for (int n = 0; n <= p; ++n) j[n * jstride] *= j0;
}

// H_n(x) = J_n(x) + i Y_n(x), n = 0..p, into h[n * hstride].
__device__ __forceinline__ void cylindrical_h(double x, int p, int nstart,
                                              double* scratch,
                                              long long stride, double2* h,
                                              int hstride) {
  // J_n (and first the products) in the real parts
  double* jr = reinterpret_cast<double*>(h);
  double ya, yb, yinv;
  if (fabs(x) < kCylSmallX) {
    cyl_j_series(x, p, jr, 2 * hstride);
    ya = kTwoOverPi * (log(0.5 * x) + kEulerGamma);
    yb = -kTwoOverPi / x;
    yinv = 1.0 / x;
  } else {
    const double xinv = 1.0 / x;
    cyl_ratios(x, xinv, nstart, scratch, stride);
    double p1, s_norm, s_y0, s_y1;
    cyl_products<true>(p, nstart, scratch, stride, jr, 2 * hstride, p1,
                       s_norm, s_y0, s_y1);
    const double j0 = 1.0 / s_norm;
    for (int n = 0; n <= p; ++n) jr[2 * n * hstride] *= j0;
    const double logterm = log(0.5 * x) + kEulerGamma;
    ya = kTwoOverPi * add_rn(logterm, mul_rn(2.0, s_y0)) * j0;    // Y_0
    yb = kTwoOverPi * sub_rn(sub_rn(mul_rn(logterm, p1), xinv), s_y1) *
         j0;                                                       // Y_1
    yinv = xinv;
  }
  for (int n = 0; n <= p; ++n) {
    double y;
    if (n == 0) {
      y = ya;
    } else if (n == 1) {
      y = yb;
    } else {
      y = sub_rn(mul_rn(mul_rn(2.0 * (n - 1), yinv), yb), ya);
      ya = yb;
      yb = y;
    }
    h[n * hstride].y = y;
  }
}

}  // namespace boxtree_torch
