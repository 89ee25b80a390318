// The two layouts of the Helmholtz particle kernels (helmholtz3d.cu,
// helmholtz2d.cu): where a kernel finds its charges and weights and where
// it reads and writes a box's expansion.  Only the global loads and stores
// depend on the layout; the kernels' inner loops work on double2 values in
// both.  Potentials are (n, 2) doubles in both, the layout of a complex128
// vector.
//
// C128Layout (the _c128 entry points, the complex wranglers): complex
//   charges and weights, and (nboxes, nc) complex coefficients, each
//   interleaved (re, im).
// PairLayout (the _f64 entry points, the real-pair wranglers of
//   boxtree_tpu/models/helmholtz3d.py:373 and helmholtz.py:296): real
//   charges, read as (q, 0); weights i c given by their real c, read as
//   (0, c); and (nboxes, 2 nc) [re | im] rows, the imaginary plane nc
//   doubles after the real one.
#pragma once

#include <cuda_runtime.h>

namespace boxtree_torch {

struct C128Layout {
  using Charge = double2;
  using Weight = double2;

  static __device__ __forceinline__ double2 charge(const double2* q,
                                                   long long i) {
    return q[i];
  }
  static __device__ __forceinline__ double2 weight(const double2* w, int i) {
    return w[i];
  }
  static __device__ __forceinline__ double2 load(const double* e,
                                                 long long box, int nc,
                                                 int i) {
    return reinterpret_cast<const double2*>(e)[box * nc + i];
  }
  static __device__ __forceinline__ void store(double* e, long long box,
                                               int nc, int i, double2 v) {
    reinterpret_cast<double2*>(e)[box * nc + i] = v;
  }
  static __device__ __forceinline__ void add(double* e, long long box, int nc,
                                             int i, double2 v) {
    double2* c = reinterpret_cast<double2*>(e) + box * nc + i;
    c->x += v.x;
    c->y += v.y;
  }
};

struct PairLayout {
  using Charge = double;
  using Weight = double;

  static __device__ __forceinline__ double2 charge(const double* q,
                                                   long long i) {
    return make_double2(q[i], 0.0);
  }
  static __device__ __forceinline__ double2 weight(const double* w, int i) {
    return make_double2(0.0, w[i]);
  }
  static __device__ __forceinline__ double2 load(const double* e,
                                                 long long box, int nc,
                                                 int i) {
    const double* row = e + box * 2 * nc;
    return make_double2(row[i], row[nc + i]);
  }
  static __device__ __forceinline__ void store(double* e, long long box,
                                               int nc, int i, double2 v) {
    double* row = e + box * 2 * nc;
    row[i] = v.x;
    row[nc + i] = v.y;
  }
  static __device__ __forceinline__ void add(double* e, long long box, int nc,
                                             int i, double2 v) {
    double* row = e + box * 2 * nc;
    row[i] += v.x;
    row[nc + i] += v.y;
  }
};

}  // namespace boxtree_torch
