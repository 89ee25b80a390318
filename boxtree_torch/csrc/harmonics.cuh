// Solid harmonics as (re, im) pairs, one coefficient at a time: the
// irregular S_n^m of the Laplace M2P (K3), P2L (K4) and dipole P2L (K23)
// kernels, and the regular R_n^m, the angular basis of the Helmholtz M2P
// (K10) and P2L (K11) kernels.  T is a float type, or a number type with
// the same arithmetic and a sqrt_t found by argument-dependent lookup (K23
// runs the irregular recurrence on dual numbers, laplace3d.cuh; the 3D
// Helmholtz dipole kernels K57-K62 the regular one, on the unit direction
// rel / r, so the tangent flows through u = rel / r, helmholtz3d.cu).
//
// The recurrences of boxtree_tpu/ops/solid_harmonics.py:161-192
// (_harmonics_pairs, kind="irregular"), in the same operation order:
//   S_0^0 = 1/r,  S_m^m = (2m-1) (x + iy) S_{m-1}^{m-1} / r^2,
//   S_{m+1}^m = (2m+1) z S_m^m / r^2,
//   S_n^m = ((2n-1) z S_{n-1}^m - ((n-1)^2 - m^2) S_{n-2}^m) / r^2.
// Only the current column's last two values live in registers; each value
// goes straight to the caller's functor f(n, m, re, im) for 0 <= m <= n,
// and the caller folds in S_n^{-m} = (-1)^m conj(S_n^m) itself.  No
// (particles x coefficients) array is ever stored.
#pragma once

#include "common.cuh"

namespace boxtree_torch {

template <typename T, typename F>
__device__ __forceinline__ void irregular_pairs_foreach(T x, T y, T z, int p,
                                                        F&& f) {
  const T r2 = x * x + y * y + z * z;
  const T rinv2 = T(1) / r2;
  T mr = sqrt_t(rinv2);
  T mi = T(0);
  for (int m = 0; m <= p; ++m) {
    if (m > 0) {
      const T ur = mr * x - mi * y;
      const T ui = mr * y + mi * x;
      mr = T(2 * m - 1) * ur * rinv2;
      mi = T(2 * m - 1) * ui * rinv2;
    }
    f(m, m, mr, mi);
    T p2r = T(0), p2i = T(0), p1r = mr, p1i = mi;
    for (int n = m + 1; n <= p; ++n) {
      T cr, ci;
      if (n == m + 1) {
        cr = T(2 * n - 1) * z * p1r * rinv2;
        ci = T(2 * n - 1) * z * p1i * rinv2;
      } else {
        const T c2 = T((n - 1) * (n - 1) - m * m);
        cr = (T(2 * n - 1) * z * p1r - c2 * p2r) * rinv2;
        ci = (T(2 * n - 1) * z * p1i - c2 * p2i) * rinv2;
      }
      f(n, m, cr, ci);
      p2r = p1r;
      p2i = p1i;
      p1r = cr;
      p1i = ci;
    }
  }
}

// The regular harmonics, by the recurrences of
// boxtree_tpu/ops/solid_harmonics.py:60-75 (_harmonics, kind="regular"), in
// the same operation order:
//   R_0^0 = 1,  R_m^m = (x + iy) R_{m-1}^{m-1} / (2m),
//   R_{m+1}^m = z R_m^m,
//   R_n^m = ((2n-1) z R_{n-1}^m - r^2 R_{n-2}^m) / ((n+m)(n-m)),
// handed to f(n, m, re, im) for 0 <= m <= n <= p as they come; the caller
// folds in R_n^{-m} = (-1)^m conj(R_n^m).
template <typename T, typename F>
__device__ __forceinline__ void regular_pairs_foreach(T x, T y, T z, int p,
                                                      F&& f) {
  const T r2 = x * x + y * y + z * z;
  T mr = T(1);
  T mi = T(0);
  for (int m = 0; m <= p; ++m) {
    if (m > 0) {
      const T ur = mr * x - mi * y;
      const T ui = mr * y + mi * x;
      mr = ur / T(2 * m);
      mi = ui / T(2 * m);
    }
    f(m, m, mr, mi);
    T p2r = T(0), p2i = T(0), p1r = mr, p1i = mi;
    for (int n = m + 1; n <= p; ++n) {
      T cr, ci;
      if (n == m + 1) {
        cr = z * p1r;
        ci = z * p1i;
      } else {
        const T den = T((n + m) * (n - m));
        cr = (T(2 * n - 1) * z * p1r - r2 * p2r) / den;
        ci = (T(2 * n - 1) * z * p1i - r2 * p2i) / den;
      }
      f(n, m, cr, ci);
      p2r = p1r;
      p2i = p1i;
      p1r = cr;
      p1i = ci;
    }
  }
}

}  // namespace boxtree_torch
