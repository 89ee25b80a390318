// K16-K18, K33-K34 and K63-K68: the particle stages of the 2D Helmholtz
// FMM (K63-K68 those of dipole sources, below), kernel
// G(t, s) = (i/4) H_0(k |t - s|) for a real wavenumber k, in double
// precision.  Coefficient index n = -p..p, stored at n + p.  Each kernel is
// a template over the layout of its charges and coefficients
// (helmholtz_layout.cuh): the _c128 entry points take complex128
// (interleaved re, im) charges and coefficients, the _f64 entry points,
// K52-K56, real charges and [re | im] rows, as the real-pair wrangler keeps
// them (boxtree_tpu/models/helmholtz.py:296
// Helmholtz2DPairsExpansionWrangler; its hooks _p2p :407, _m2p_eval :391,
// _p2l_terms :400, _p2m_terms :378 and _l2p_eval :384 over :342
// _basis_pairs and :91 _device_JY compute the same functions in pair
// lanes).  Potentials are (n, 2) doubles in both.
//
// K52 p2p_helmholtz2d_f64, K53 m2p_helmholtz2d_f64, K54
// p2l_helmholtz2d_f64, K55 p2m_helmholtz2d_f64 and K56 l2p_helmholtz2d_f64
// are K16, K17, K18, K33 and K34 on the pair layout: a real charge enters
// the kernels' double2 slot as (q, 0), M2P and L2P stage the box's
// [re | im] row into the same double2 shared array from its two planes,
// and P2M and P2L store or add their sums into the two planes.  The inner
// loops, the global ratio scratch and the fixed grid are the same code.
//
// K16 p2p_helmholtz2d: List-1 potentials, phi(t) = sum q_s (i/4) H_0(k r),
//     r = 0 skipped.  Replaces boxtree_tpu/models/expansion_base.py:1258
//     _eval_direct_rowmajor with boxtree_tpu/models/helmholtz.py:284 _p2p
//     (and :59 _device_JH, ops/cylinder_bessel.py:46).
// K17 m2p_helmholtz2d: List-3 potentials from the multipoles of the listed
//     source boxes, phi(t) += sum_n a_n H_n(k r) e^{i n th} s^|n| with
//     r e^{i th} = ((t - c) / s) s, 0 at r = 0.  Replaces
//     expansion_base.py:1440 _eval_multipoles_rowmajor with helmholtz.py:275
//     _m2p_eval (via :232 _basis).
// K18 p2l_helmholtz2d: List-4 local expansions, b_n(b) += (i/4) q_s
//     H_n(k r) e^{-i n th} s^|n| with r e^{i th} = ((x_s - c_b) / s) s,
//     added in place into the box's coefficients.  Replaces
//     expansion_base.py:1629 _form_locals_rowmajor with helmholtz.py:279
//     _p2l_terms.
// K33 p2m_helmholtz2d: multipoles, a_n(b) = sum_s (i/4) q_s J_n(k r)
//     e^{-i n th} s^-|n| over the sources box b owns itself (its nonchild
//     range, on any level), written once into the box's row; r = 0 gives
//     the exact limit J_n(0) = [n == 0].  Replaces expansion_base.py:652
//     form_multipoles with helmholtz.py:267 _p2m_terms (via :232 _basis).
// K34 l2p_helmholtz2d: phi(t) = sum_n b_n(b) J_n(k r) e^{i n th} s^-|n| for
//     every target box b owns itself, written once; b_0(b) at r = 0.
//     Replaces expansion_base.py:1793 eval_locals with helmholtz.py:271
//     _l2p_eval.
//
// Negative orders come from F_{-n} = (-1)^n F_n; s is the box's rscale.  As
// in the 3D kernels (helmholtz3d.cu), a box's nonchild particles are the
// contiguous tree-order range [box_*_starts, + box_*_counts_nonchild), rows
// of the CSR lists (K16-K18) or the row list itself (K33, K34, the boxes
// that own particles) name boxes, and one CTA (one warp) serves one row.
//
// Bound: float64 arithmetic.  K16 runs over ~1.2e8 pairs on the path, so it
// evaluates H_0 with CUDA's double j0() and y0() (a few rational
// approximations and a log; accurate to a few ulp at the path's k r) rather
// than the twin's ~56-step recurrence, with its sources staged 32 at a time
// in shared memory.  K17, K18, K33 and K34 run the recurrence of
// cyl_bessel.cuh per (particle, box) pair (nstart double divides down,
// nstart products up) and fold the 2p+1 coefficients: K17 and K34 against
// the box's expansion in shared memory; K18 with each lane writing its
// source's 2p+1 terms to a column of a shared table, then each lane summing
// the rows of the coefficients it owns; K33 summing each coefficient over
// the warp with shuffles, lane 0 adding it to the box's row in shared
// memory.  No atomics on the results.  The recurrence's ratios go to a
// global scratch buffer, one column a thread; these four kernels run a
// fixed grid (the wrapper's, a few CTAs an SM) whose CTAs take rows one at
// a time from a counter (the wrapper zeroes it; a row's result does not
// depend on which CTA computes it), as the hardware hands out CTAs when
// there is one per row, so the buffer is sized by that grid and the grid's
// threads reuse their columns.  Only the tables of 2p+1 or p+1 values a
// lane stay in shared memory.
//
// The dipole kernels: sources of weight q and dipole d, the potential q (d .
// grad_y) (i/4) H_0(k |x - y|).  Each computes the tangent that JAX's JVP of
// the charge hook takes in the source positions (boxtree_tpu/models/
// expansion_base.py:664-673, :1314-1324, :1688-1694, with the custom JVPs
// of helmholtz.py:58 _device_JH and :88 _device_JY), not by running the
// charge kernel on duals but by the ladder identity
//   (d . grad)[Z_n(k r) e^{-i n th}]
//       = (k/2) [(d_x - i d_y) C_{n-1} - (d_x + i d_y) C_{n+1}],
//   C_m = Z_m(k r) e^{-i m th},  C_{-m} = (-1)^m Z_m e^{i m th},
// for Z = J and Z = H^(1): the orders up to p + 1 of the recurrence the
// charge kernel runs (the wrapper's nstart is even_start(nstart, p + 1) and
// its scratch is sized for it), one sincos a step as K33 / K18, and no
// division by r, so r = 0 gives the limit by itself.  The offset's tangent
// is d / s times s, as the reference hands its hooks d / s.
// K63 / K66 p2m_helmholtz2d_dipole: K33's loop with the ladder terms; a
//     source on its box's centre (r = 0, th = 0, J_m(0) = [m == 0]) adds
//     (i/4) q (k/2) (d_x - i d_y) s^-1 at n = 1 and -(i/4) q (k/2) (d_x +
//     i d_y) s^-1 at n = -1, the limit of the tangent, where the reference's
//     guard gives 0.  Replaces the jax.jvp of helmholtz.py:267 _p2m_terms
//     (pairs :378) in expansion_base.py:664-673.
// K64 / K67 p2p_helmholtz2d_dipole: K16 with the dipoles staged beside the
//     sources, phi(t) = sum q (i/4) k H_1(k r) d . (t - s) / r with CUDA's
//     double j1() / y1(), r = 0 skipped.  Replaces the jax.jvp of
//     helmholtz.py:284 _p2p (pairs :407) in expansion_base.py:1314-1324.
// K65 / K68 p2l_helmholtz2d_dipole: K18's loop with the ladder terms of H,
//     its table p + 2 complex values a lane; 0 at r = 0, as the reference.
//     Replaces the jax.jvp of helmholtz.py:279 _p2l_terms (pairs :400) in
//     expansion_base.py:1688-1694.
#include "cyl_bessel.cuh"
#include "helmholtz_layout.cuh"

namespace boxtree_torch {
namespace {

constexpr int kH2Threads = 32;

__device__ __forceinline__ double2 cmul2(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The next row for the calling CTA (one warp), from the launch's counter.
__device__ __forceinline__ int next_row(int* counter) {
  int row = 0;
  if (threadIdx.x == 0) row = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, row, 0);
}

// {{{ K16

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2p_helmholtz2d_kernel(const double* __restrict__ targets,
                       long long ntargets, const double* __restrict__ sources,
                       long long nsources,
                       const typename L::Charge* __restrict__ charges,
                       const int* __restrict__ box_target_starts,
                       const int* __restrict__ box_target_counts,
                       const int* __restrict__ box_source_starts,
                       const int* __restrict__ box_source_counts,
                       const int* __restrict__ target_boxes,
                       const int* __restrict__ starts,
                       const int* __restrict__ lists, double k,
                       double2* __restrict__ out) {
  __shared__ double sx[kH2Threads], sy[kH2Threads];
  __shared__ double2 sq[kH2Threads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kH2Threads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    double tx = 0.0, ty = 0.0;
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
    }
    double ar = 0.0, ai = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kH2Threads) {
        const int cnt = min(kH2Threads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sq[threadIdx.x] = L::charge(charges, s);
        }
        __syncthreads();
        if (!active) continue;
        for (int j = 0; j < cnt; ++j) {
          const double dx = tx - sx[j], dy = ty - sy[j];
          const double r = sqrt(dx * dx + dy * dy);
          if (r > 0.0) {
            const double kr = k * r;
            // (i/4) (J_0 + i Y_0) q; CUDA's j0/y0 hold at every k r > 0,
            // below the twin's series switch too (cyl_bessel.cuh)
            const double2 g = make_double2(-0.25 * y0(kr), 0.25 * j0(kr));
            const double2 v = cmul2(g, sq[j]);
            ar += v.x;
            ai += v.y;
          }
        }
      }
    }
    if (active) out[t0 + ti] = make_double2(ar, ai);
  }
}

// }}}

// {{{ K17

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
m2p_helmholtz2d_kernel(const double* __restrict__ targets,
                       long long ntargets,
                       const int* __restrict__ box_target_starts,
                       const int* __restrict__ box_target_counts,
                       const int* __restrict__ rows, long long nrows,
                       const int* __restrict__ starts,
                       const int* __restrict__ lists,
                       const double* __restrict__ mpoles,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       int nstart, double* __restrict__ scratch,
                       int* __restrict__ counter,
                       double2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* smp = reinterpret_cast<double2*>(smem_raw);        // nc
  double2* hb = smp + nc;                                     // (p+1) x warp
  double* geo = reinterpret_cast<double*>(hb + (p + 1) * kH2Threads);
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const int tbox = rows[row];
    const long long t0 = box_target_starts[tbox];
    const int nt = box_target_counts[tbox];
    const int e0 = starts[row], e1 = starts[row + 1];
    for (int tb = 0; tb < nt; tb += kH2Threads) {
      const int ti = tb + lane;
      const bool active = ti < nt;
      double tx = 0.0, ty = 0.0;
      if (active) {
        tx = targets[t0 + ti];
        ty = targets[ntargets + t0 + ti];
      }
      double ar = 0.0, ai = 0.0;
      for (int e = e0; e < e1; ++e) {
        const long long sbox = lists[e];
        __syncthreads();
        for (int i = lane; i < nc; i += kH2Threads)
          smp[i] = L::load(mpoles, sbox, nc, i);
        if (lane == 0) {
          geo[0] = centers[sbox];
          geo[1] = centers[nboxes + sbox];
          geo[2] = box_scale[sbox];
        }
        __syncthreads();
        if (!active) continue;
        // the reference's hook receives (t - c) / s and works on that
        // times s
        const double s = geo[2];
        const double x = (tx - geo[0]) / s * s;
        const double y = (ty - geo[1]) / s * s;
        const double r = sqrt(x * x + y * y);
        if (!(r > 0.0)) continue;
        const double th = atan2(y, x);
        cylindrical_h(k * r, p, nstart, col, stride, hb + lane, kH2Threads);
        double vr = 0.0, vi = 0.0;
        for (int m = 0; m <= p; ++m) {
          double sn, cs;
          sincos(m * th, &sn, &cs);
          const double pw = pow(s, double(m));
          const double2 h = hb[m * kH2Threads + lane];
          // a_m H_m e^{i m th} s^m
          double2 b = cmul2(h, make_double2(cs, sn));
          b = make_double2(b.x * pw, b.y * pw);
          const double2 a = smp[p + m];
          vr += a.x * b.x - a.y * b.y;
          vi += a.x * b.y + a.y * b.x;
          if (m > 0) {
            // a_{-m} (-1)^m H_m e^{-i m th} s^m
            const double sg = (m & 1) ? -1.0 : 1.0;
            double2 c = cmul2(make_double2(sg * h.x, sg * h.y),
                              make_double2(cs, -sn));
            c = make_double2(c.x * pw, c.y * pw);
            const double2 a2 = smp[p - m];
            vr += a2.x * c.x - a2.y * c.y;
            vi += a2.x * c.y + a2.y * c.x;
          }
        }
        ar += vr;
        ai += vi;
      }
      if (active) out[t0 + ti] = make_double2(ar, ai);
    }
  }
}

// }}}

// {{{ K18

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2l_helmholtz2d_kernel(const double* __restrict__ sources,
                       long long nsources,
                       const typename L::Charge* __restrict__ charges,
                       const int* __restrict__ box_source_starts,
                       const int* __restrict__ box_source_counts,
                       const int* __restrict__ rows, long long nrows,
                       const int* __restrict__ starts,
                       const int* __restrict__ lists,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       int nstart, double* __restrict__ scratch,
                       int* __restrict__ counter,
                       double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* terms = reinterpret_cast<double2*>(smem_raw);      // nc x warp
  double2* acc = terms + nc * kH2Threads;                     // nc
  double2* hb = acc + nc;                                     // (p+1) x warp
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const long long tbox = rows[row];
    const int e0 = starts[row], e1 = starts[row + 1];
    for (int i = lane; i < nc; i += kH2Threads) acc[i] = make_double2(0, 0);
    const double cx = centers[tbox], cy = centers[nboxes + tbox];
    const double s = box_scale[tbox];

    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kH2Threads) {
        const int j = sb + lane;
        double x = 0.0, y = 0.0, r = 0.0;
        if (j < ns) {
          x = (sources[s0 + j] - cx) / s * s;
          y = (sources[nsources + s0 + j] - cy) / s * s;
          r = sqrt(x * x + y * y);
        }
        if (r > 0.0) {
          // (i/4) q (-1)^{m [n < 0]} H_m e^{-i n th} s^m, m = |n|
          const double2 q = L::charge(charges, s0 + j);
          const double2 qq = make_double2(-0.25 * q.y, 0.25 * q.x);
          const double th = atan2(y, x);
          cylindrical_h(k * r, p, nstart, col, stride, hb + lane,
                        kH2Threads);
          for (int m = 0; m <= p; ++m) {
            double sn, cs;
            sincos(m * th, &sn, &cs);
            const double pw = pow(s, double(m));
            const double2 h = hb[m * kH2Threads + lane];
            double2 b = cmul2(h, make_double2(cs, -sn));
            b = make_double2(b.x * pw, b.y * pw);
            terms[(p + m) * kH2Threads + lane] = cmul2(qq, b);
            if (m > 0) {
              const double sg = (m & 1) ? -1.0 : 1.0;
              double2 c = cmul2(make_double2(sg * h.x, sg * h.y),
                                make_double2(cs, sn));
              c = make_double2(c.x * pw, c.y * pw);
              terms[(p - m) * kH2Threads + lane] = cmul2(qq, c);
            }
          }
        } else {
          for (int i = 0; i < nc; ++i)
            terms[i * kH2Threads + lane] = make_double2(0.0, 0.0);
        }
        __syncwarp();
        // each lane sums the rows of the coefficients it owns
        for (int i = lane; i < nc; i += kH2Threads) {
          double tr = 0.0, tim = 0.0;
          for (int jj = 0; jj < kH2Threads; ++jj) {
            const double2 t = terms[i * kH2Threads + jj];
            tr += t.x;
            tim += t.y;
          }
          acc[i].x += tr;
          acc[i].y += tim;
        }
        __syncwarp();
      }
    }
    for (int i = lane; i < nc; i += kH2Threads)
      L::add(out, tbox, nc, i, acc[i]);
  }
}

// }}}

// {{{ K33

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2m_helmholtz2d_kernel(const double* __restrict__ sources,
                       long long nsources,
                       const typename L::Charge* __restrict__ charges,
                       const int* __restrict__ box_source_starts,
                       const int* __restrict__ box_source_counts,
                       const int* __restrict__ rows, long long nrows,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       int nstart, double* __restrict__ scratch,
                       int* __restrict__ counter,
                       double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* acc = reinterpret_cast<double2*>(smem_raw);        // nc
  double* jt = reinterpret_cast<double*>(acc + nc);           // (p+1) x warp
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const long long box = rows[row];
    const long long s0 = box_source_starts[box];
    const int ns = box_source_counts[box];
    for (int i = lane; i < nc; i += kH2Threads) acc[i] = make_double2(0, 0);
    const double cx = centers[box], cy = centers[nboxes + box];
    const double s = box_scale[box];
    __syncwarp();

    for (int sb = 0; sb < ns; sb += kH2Threads) {
      const int j = sb + lane;
      // idle lanes evaluate at the centre with zero charge; r = 0 takes
      // J_n(0) = [n == 0] and th = 0, the reference's one-hot limit
      double x = 0.0, y = 0.0;
      double2 qq = make_double2(0.0, 0.0);
      if (j < ns) {
        x = (sources[s0 + j] - cx) / s * s;
        y = (sources[nsources + s0 + j] - cy) / s * s;
        const double2 q = L::charge(charges, s0 + j);
        qq = make_double2(-0.25 * q.y, 0.25 * q.x);  // (i/4) q
      }
      const double r = sqrt(x * x + y * y);
      const double th = atan2(y, x);
      cylindrical_j(k * r, p, nstart, col, stride, jt + lane, kH2Threads);
      for (int m = 0; m <= p; ++m) {
        double sn, cs;
        sincos(m * th, &sn, &cs);
        const double pw = pow(s, -double(m));
        const double jm = jt[m * kH2Threads + lane];
        // (i/4) q J_m e^{-i m th} s^-m at n = m, and (i/4) q (-1)^m J_m
        // e^{i m th} s^-m at n = -m, each summed over the warp
        const double2 b = cmul2(qq, make_double2(jm * cs * pw,
                                                 -(jm * sn) * pw));
        const double vr = warp_sum(b.x), vi = warp_sum(b.y);
        double ur = 0.0, ui = 0.0;
        if (m > 0) {
          const double sj = (m & 1) ? -jm : jm;
          const double2 c = cmul2(qq, make_double2(sj * cs * pw,
                                                   sj * sn * pw));
          ur = warp_sum(c.x);
          ui = warp_sum(c.y);
        }
        if (lane == 0) {
          acc[p + m].x += vr;
          acc[p + m].y += vi;
          if (m > 0) {
            acc[p - m].x += ur;
            acc[p - m].y += ui;
          }
        }
      }
    }
    __syncwarp();
    for (int i = lane; i < nc; i += kH2Threads)
      L::store(out, box, nc, i, acc[i]);
    __syncwarp();
  }
}

// }}}

// {{{ K34

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
l2p_helmholtz2d_kernel(const double* __restrict__ targets,
                       long long ntargets,
                       const int* __restrict__ box_target_starts,
                       const int* __restrict__ box_target_counts,
                       const int* __restrict__ rows, long long nrows,
                       const double* __restrict__ locs,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       int nstart, double* __restrict__ scratch,
                       int* __restrict__ counter,
                       double2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* sl = reinterpret_cast<double2*>(smem_raw);         // nc
  double* jt = reinterpret_cast<double*>(sl + nc);            // (p+1) x warp
  double* geo = jt + (p + 1) * kH2Threads;                    // cx, cy, s
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const long long box = rows[row];
    const long long t0 = box_target_starts[box];
    const int nt = box_target_counts[box];
    __syncthreads();
    for (int i = lane; i < nc; i += kH2Threads)
      sl[i] = L::load(locs, box, nc, i);
    if (lane == 0) {
      geo[0] = centers[box];
      geo[1] = centers[nboxes + box];
      geo[2] = box_scale[box];
    }
    __syncthreads();
    const double s = geo[2];

    for (int ti = lane; ti < nt; ti += kH2Threads) {
      // r = 0 takes J_n(0) = [n == 0] and th = 0: b_0, as the reference
      const double x = (targets[t0 + ti] - geo[0]) / s * s;
      const double y = (targets[ntargets + t0 + ti] - geo[1]) / s * s;
      const double r = sqrt(x * x + y * y);
      const double th = atan2(y, x);
      cylindrical_j(k * r, p, nstart, col, stride, jt + lane, kH2Threads);
      double vr = 0.0, vi = 0.0;
      for (int m = 0; m <= p; ++m) {
        double sn, cs;
        sincos(m * th, &sn, &cs);
        const double pw = pow(s, -double(m));
        const double jm = jt[m * kH2Threads + lane];
        // b_m J_m e^{i m th} s^-m + b_{-m} (-1)^m J_m e^{-i m th} s^-m
        const double br = jm * cs * pw, bi = jm * sn * pw;
        const double2 a = sl[p + m];
        vr += a.x * br - a.y * bi;
        vi += a.x * bi + a.y * br;
        if (m > 0) {
          const double sg = (m & 1) ? -1.0 : 1.0;
          const double cr = sg * jm * cs * pw, ci = -(sg * jm * sn) * pw;
          const double2 a2 = sl[p - m];
          vr += a2.x * cr - a2.y * ci;
          vi += a2.x * ci + a2.y * cr;
        }
      }
      out[t0 + ti] = make_double2(vr, vi);
    }
  }
}

// }}}

// {{{ K63-K68: the dipole kernels

// C_m = z e^{-i m th} for m >= 0 and (-1)^|m| z e^{i |m| th} for m < 0,
// with z = Z_|m| and (c, sn) = (cos, sin) of |m| th.
__device__ __forceinline__ double2 ladder_basis(double2 z, int m, double c,
                                                double sn) {
  if (m >= 0) return cmul2(z, make_double2(c, -sn));
  const double2 v = cmul2(z, make_double2(c, sn));
  return (m & 1) ? make_double2(-v.x, -v.y) : v;
}

// The tangents (d . grad)[Z_n e^{-i n th}] at n = m and n = -m (m >= 0) from
// Z_{m-1}, Z_{m+1} (zlo = Z_|m-1|, zhi) and the phases of |m - 1| th (clo,
// slo) and (m + 1) th (chi, shi); dd = (d_x, d_y), half_k = k / 2.
__device__ __forceinline__ void ladder_tangents(
    double2 zlo, double2 zhi, int m, double clo, double slo, double chi,
    double shi, double2 dd, double half_k, double2& tp, double2& tm) {
  const double2 dbar = make_double2(dd.x, -dd.y), d = dd;
  const double2 a = cmul2(dbar, ladder_basis(zlo, m - 1, clo, slo));
  const double2 b = cmul2(d, ladder_basis(zhi, m + 1, chi, shi));
  tp = make_double2(half_k * (a.x - b.x), half_k * (a.y - b.y));
  const double2 a2 = cmul2(dbar, ladder_basis(zhi, -m - 1, chi, shi));
  const double2 b2 = cmul2(d, ladder_basis(zlo, 1 - m, clo, slo));
  tm = make_double2(half_k * (a2.x - b2.x), half_k * (a2.y - b2.y));
}

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2p_helmholtz2d_dipole_kernel(
    const double* __restrict__ targets, long long ntargets,
    const double* __restrict__ sources, long long nsources,
    const typename L::Charge* __restrict__ charges,
    const double* __restrict__ dipoles,
    const int* __restrict__ box_target_starts,
    const int* __restrict__ box_target_counts,
    const int* __restrict__ box_source_starts,
    const int* __restrict__ box_source_counts,
    const int* __restrict__ target_boxes, const int* __restrict__ starts,
    const int* __restrict__ lists, double k, double2* __restrict__ out) {
  __shared__ double sx[kH2Threads], sy[kH2Threads];
  __shared__ double sdx[kH2Threads], sdy[kH2Threads];
  __shared__ double2 sq[kH2Threads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kH2Threads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    double tx = 0.0, ty = 0.0;
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
    }
    double ar = 0.0, ai = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kH2Threads) {
        const int cnt = min(kH2Threads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sdx[threadIdx.x] = dipoles[s];
          sdy[threadIdx.x] = dipoles[nsources + s];
          sq[threadIdx.x] = L::charge(charges, s);
        }
        __syncthreads();
        if (!active) continue;
        for (int j = 0; j < cnt; ++j) {
          const double dx = tx - sx[j], dy = ty - sy[j];
          const double r = sqrt(dx * dx + dy * dy);
          if (r > 0.0) {
            const double kr = k * r;
            // (i/4) k (J_1 + i Y_1) d . (t - s) / r, times q
            const double f = k * (sdx[j] * dx + sdy[j] * dy) / r;
            const double2 g =
                make_double2(-0.25 * y1(kr) * f, 0.25 * j1(kr) * f);
            const double2 v = cmul2(g, sq[j]);
            ar += v.x;
            ai += v.y;
          }
        }
      }
    }
    if (active) out[t0 + ti] = make_double2(ar, ai);
  }
}

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2l_helmholtz2d_dipole_kernel(
    const double* __restrict__ sources, long long nsources,
    const typename L::Charge* __restrict__ charges,
    const double* __restrict__ dipoles,
    const int* __restrict__ box_source_starts,
    const int* __restrict__ box_source_counts, const int* __restrict__ rows,
    long long nrows, const int* __restrict__ starts,
    const int* __restrict__ lists, const double* __restrict__ centers,
    long long nboxes, const double* __restrict__ box_scale, double k, int p,
    int nstart, double* __restrict__ scratch, int* __restrict__ counter,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* terms = reinterpret_cast<double2*>(smem_raw);      // nc x warp
  double2* acc = terms + nc * kH2Threads;                     // nc
  double2* hb = acc + nc;                                     // (p+2) x warp
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;
  const double half_k = 0.5 * k;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const long long tbox = rows[row];
    const int e0 = starts[row], e1 = starts[row + 1];
    for (int i = lane; i < nc; i += kH2Threads) acc[i] = make_double2(0, 0);
    const double cx = centers[tbox], cy = centers[nboxes + tbox];
    const double s = box_scale[tbox];

    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kH2Threads) {
        const int j = sb + lane;
        double x = 0.0, y = 0.0, r = 0.0;
        if (j < ns) {
          x = (sources[s0 + j] - cx) / s * s;
          y = (sources[nsources + s0 + j] - cy) / s * s;
          r = sqrt(x * x + y * y);
        }
        if (r > 0.0) {
          // (i/4) q (d . grad)[H_n e^{-i n th}] s^|n|
          const double2 q = L::charge(charges, s0 + j);
          const double2 qq = make_double2(-0.25 * q.y, 0.25 * q.x);
          const double2 dd =
              make_double2(dipoles[s0 + j] / s * s,
                           dipoles[nsources + s0 + j] / s * s);
          const double th = atan2(y, x);
          cylindrical_h(k * r, p + 1, nstart, col, stride, hb + lane,
                        kH2Threads);
          double slo, clo, shi, chi, smid, cmid;
          sincos(th, &slo, &clo);  // |m - 1| th at m = 0
          smid = 0.0;
          cmid = 1.0;
          for (int m = 0; m <= p; ++m) {
            sincos((m + 1) * th, &shi, &chi);
            const double pw = pow(s, double(m));
            double2 tp, tm;
            ladder_tangents(hb[abs(m - 1) * kH2Threads + lane],
                            hb[(m + 1) * kH2Threads + lane], m, clo, slo,
                            chi, shi, dd, half_k, tp, tm);
            tp = cmul2(qq, tp);
            terms[(p + m) * kH2Threads + lane] =
                make_double2(tp.x * pw, tp.y * pw);
            if (m > 0) {
              tm = cmul2(qq, tm);
              terms[(p - m) * kH2Threads + lane] =
                  make_double2(tm.x * pw, tm.y * pw);
            }
            clo = cmid;
            slo = smid;
            cmid = chi;
            smid = shi;
          }
        } else {
          for (int i = 0; i < nc; ++i)
            terms[i * kH2Threads + lane] = make_double2(0.0, 0.0);
        }
        __syncwarp();
        for (int i = lane; i < nc; i += kH2Threads) {
          double tr = 0.0, tim = 0.0;
          for (int jj = 0; jj < kH2Threads; ++jj) {
            const double2 t = terms[i * kH2Threads + jj];
            tr += t.x;
            tim += t.y;
          }
          acc[i].x += tr;
          acc[i].y += tim;
        }
        __syncwarp();
      }
    }
    for (int i = lane; i < nc; i += kH2Threads)
      L::add(out, tbox, nc, i, acc[i]);
  }
}

template <typename L>
__global__ void __launch_bounds__(kH2Threads)
p2m_helmholtz2d_dipole_kernel(
    const double* __restrict__ sources, long long nsources,
    const typename L::Charge* __restrict__ charges,
    const double* __restrict__ dipoles,
    const int* __restrict__ box_source_starts,
    const int* __restrict__ box_source_counts, const int* __restrict__ rows,
    long long nrows, const double* __restrict__ centers, long long nboxes,
    const double* __restrict__ box_scale, double k, int p, int nstart,
    double* __restrict__ scratch, int* __restrict__ counter,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = 2 * p + 1;
  double2* acc = reinterpret_cast<double2*>(smem_raw);        // nc
  double* jt = reinterpret_cast<double*>(acc + nc);           // (p+2) x warp
  const int lane = threadIdx.x;
  const long long stride = (long long)gridDim.x * kH2Threads;
  double* col = scratch + (long long)blockIdx.x * kH2Threads + lane;
  const double half_k = 0.5 * k;

  for (int row = next_row(counter); row < nrows;
       row = next_row(counter)) {
    const long long box = rows[row];
    const long long s0 = box_source_starts[box];
    const int ns = box_source_counts[box];
    for (int i = lane; i < nc; i += kH2Threads) acc[i] = make_double2(0, 0);
    const double cx = centers[box], cy = centers[nboxes + box];
    const double s = box_scale[box];
    __syncwarp();

    for (int sb = 0; sb < ns; sb += kH2Threads) {
      const int j = sb + lane;
      // idle lanes: zero charge and dipole at the centre
      double x = 0.0, y = 0.0;
      double2 qq = make_double2(0.0, 0.0), dd = make_double2(0.0, 0.0);
      if (j < ns) {
        x = (sources[s0 + j] - cx) / s * s;
        y = (sources[nsources + s0 + j] - cy) / s * s;
        const double2 q = L::charge(charges, s0 + j);
        qq = make_double2(-0.25 * q.y, 0.25 * q.x);  // (i/4) q
        dd = make_double2(dipoles[s0 + j] / s * s,
                          dipoles[nsources + s0 + j] / s * s);
      }
      const double r = sqrt(x * x + y * y);
      const double th = atan2(y, x);
      cylindrical_j(k * r, p + 1, nstart, col, stride, jt + lane,
                    kH2Threads);
      double slo, clo, shi, chi, smid, cmid;
      sincos(th, &slo, &clo);  // |m - 1| th at m = 0
      smid = 0.0;
      cmid = 1.0;
      for (int m = 0; m <= p; ++m) {
        sincos((m + 1) * th, &shi, &chi);
        const double pw = pow(s, -double(m));
        double2 tp, tm;
        ladder_tangents(make_double2(jt[abs(m - 1) * kH2Threads + lane], 0.0),
                        make_double2(jt[(m + 1) * kH2Threads + lane], 0.0),
                        m, clo, slo, chi, shi, dd, half_k, tp, tm);
        // (i/4) q T_{+-m} s^-m, each summed over the warp
        const double2 b = cmul2(qq, tp);
        const double vr = warp_sum(b.x * pw), vi = warp_sum(b.y * pw);
        double ur = 0.0, ui = 0.0;
        if (m > 0) {
          const double2 c = cmul2(qq, tm);
          ur = warp_sum(c.x * pw);
          ui = warp_sum(c.y * pw);
        }
        if (lane == 0) {
          acc[p + m].x += vr;
          acc[p + m].y += vi;
          if (m > 0) {
            acc[p - m].x += ur;
            acc[p - m].y += ui;
          }
        }
        clo = cmid;
        slo = smid;
        cmid = chi;
        smid = shi;
      }
    }
    __syncwarp();
    for (int i = lane; i < nc; i += kH2Threads)
      L::store(out, box, nc, i, acc[i]);
    __syncwarp();
  }
}

// }}}

size_t m2p_smem(long long p) {
  return ((2 * p + 1) + (p + 1) * kH2Threads) * sizeof(double2) +
         3 * sizeof(double);
}

size_t p2l_smem(long long p) {
  return ((2 * p + 1) * (kH2Threads + 1) + (p + 1) * kH2Threads) *
         sizeof(double2);
}

size_t p2m_smem(long long p) {
  return (2 * p + 1) * sizeof(double2) +
         (p + 1) * kH2Threads * sizeof(double);
}

// K65 / K68 and K63 / K66: the tables hold the orders 0..p+1
size_t p2l_dipole_smem(long long p) {
  return ((2 * p + 1) * (kH2Threads + 1) + (p + 2) * kH2Threads) *
         sizeof(double2);
}

size_t p2m_dipole_smem(long long p) {
  return (2 * p + 1) * sizeof(double2) +
         (p + 2) * kH2Threads * sizeof(double);
}

size_t l2p_smem(long long p) {
  return (2 * p + 1) * sizeof(double2) +
         ((p + 1) * kH2Threads + 3) * sizeof(double);
}

// {{{ launches, one per kernel and layout

template <typename L>
int p2p_launch(const void* targets, long long ntargets, const void* sources,
               long long nsources, const void* charges, const void* bts,
               const void* btc, const void* bss, const void* bsc,
               const void* target_boxes, long long nrows, const void* starts,
               const void* lists, double k, void* out, void* stream) {
  if (nrows > 0) {
    p2p_helmholtz2d_kernel<L><<<(unsigned)nrows, kH2Threads, 0,
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bts,
        (const int*)btc, (const int*)bss, (const int*)bsc,
        (const int*)target_boxes, (const int*)starts, (const int*)lists, k,
        (double2*)out);
  }
  return (int)cudaGetLastError();
}

// K17, K18, K33 and K34 launch *grid* CTAs over their *nrows* rows, with
// *scratch* holding nstart x (grid x 32) doubles and *counter* one int,
// zeroed.

template <typename L>
int m2p_launch(const void* targets, long long ntargets, const void* bts,
               const void* btc, const void* rows, long long nrows,
               const void* starts, const void* lists, const void* mpoles,
               const void* centers, long long nboxes, const void* box_scale,
               double k, long long order, long long nstart, long long grid,
               void* scratch, void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = m2p_smem(order);
    const cudaError_t err = allow_smem(m2p_helmholtz2d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    m2p_helmholtz2d_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, nrows, (const int*)starts, (const int*)lists,
        (const double*)mpoles, (const double*)centers, nboxes,
        (const double*)box_scale, k, (int)order, (int)nstart,
        (double*)scratch, (int*)counter, (double2*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2l_launch(const void* sources, long long nsources, const void* charges,
               const void* bss, const void* bsc, const void* rows,
               long long nrows, const void* starts, const void* lists,
               const void* centers, long long nboxes, const void* box_scale,
               double k, long long order, long long nstart, long long grid,
               void* scratch, void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = p2l_smem(order);
    const cudaError_t err = allow_smem(p2l_helmholtz2d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2l_helmholtz2d_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bss,
        (const int*)bsc, (const int*)rows, nrows, (const int*)starts,
        (const int*)lists, (const double*)centers, nboxes,
        (const double*)box_scale, k, (int)order, (int)nstart,
        (double*)scratch, (int*)counter, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2m_launch(const void* sources, long long nsources, const void* charges,
               const void* bss, const void* bsc, const void* rows,
               long long nrows, const void* centers, long long nboxes,
               const void* box_scale, double k, long long order,
               long long nstart, long long grid, void* scratch,
               void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = p2m_smem(order);
    const cudaError_t err = allow_smem(p2m_helmholtz2d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_helmholtz2d_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bss,
        (const int*)bsc, (const int*)rows, nrows, (const double*)centers,
        nboxes, (const double*)box_scale, k, (int)order, (int)nstart,
        (double*)scratch, (int*)counter, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int l2p_launch(const void* targets, long long ntargets, const void* bts,
               const void* btc, const void* rows, long long nrows,
               const void* locs, const void* centers, long long nboxes,
               const void* box_scale, double k, long long order,
               long long nstart, long long grid, void* scratch,
               void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = l2p_smem(order);
    const cudaError_t err = allow_smem(l2p_helmholtz2d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    l2p_helmholtz2d_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, nrows, (const double*)locs,
        (const double*)centers, nboxes, (const double*)box_scale, k,
        (int)order, (int)nstart, (double*)scratch, (int*)counter,
        (double2*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2p_dipole_launch(const void* targets, long long ntargets,
                      const void* sources, long long nsources,
                      const void* charges, const void* dipoles,
                      const void* bts, const void* btc, const void* bss,
                      const void* bsc, const void* target_boxes,
                      long long nrows, const void* starts, const void* lists,
                      double k, void* out, void* stream) {
  if (nrows > 0) {
    p2p_helmholtz2d_dipole_kernel<L><<<(unsigned)nrows, kH2Threads, 0,
                                       (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bts, (const int*)btc, (const int*)bss, (const int*)bsc,
        (const int*)target_boxes, (const int*)starts, (const int*)lists, k,
        (double2*)out);
  }
  return (int)cudaGetLastError();
}

// K63 / K66 and K65 / K68: *nstart* is the start for order p + 1 and
// *scratch* holds that many doubles a thread of the grid.

template <typename L>
int p2l_dipole_launch(const void* sources, long long nsources,
                      const void* charges, const void* dipoles,
                      const void* bss, const void* bsc, const void* rows,
                      long long nrows, const void* starts, const void* lists,
                      const void* centers, long long nboxes,
                      const void* box_scale, double k, long long order,
                      long long nstart, long long grid, void* scratch,
                      void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = p2l_dipole_smem(order);
    const cudaError_t err =
        allow_smem(p2l_helmholtz2d_dipole_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2l_helmholtz2d_dipole_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                       (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows, nrows,
        (const int*)starts, (const int*)lists, (const double*)centers,
        nboxes, (const double*)box_scale, k, (int)order, (int)nstart,
        (double*)scratch, (int*)counter, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2m_dipole_launch(const void* sources, long long nsources,
                      const void* charges, const void* dipoles,
                      const void* bss, const void* bsc, const void* rows,
                      long long nrows, const void* centers, long long nboxes,
                      const void* box_scale, double k, long long order,
                      long long nstart, long long grid, void* scratch,
                      void* counter, void* out, void* stream) {
  if (nrows > 0 && grid > 0) {
    const size_t smem = p2m_dipole_smem(order);
    const cudaError_t err =
        allow_smem(p2m_helmholtz2d_dipole_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_helmholtz2d_dipole_kernel<L><<<(unsigned)grid, kH2Threads, smem,
                                       (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows, nrows,
        (const double*)centers, nboxes, (const double*)box_scale, k,
        (int)order, (int)nstart, (double*)scratch, (int*)counter,
        (double*)out);
  }
  return (int)cudaGetLastError();
}

// }}}

}  // namespace
}  // namespace boxtree_torch

// The C entry points: <name>_c128 on C128Layout (K16-K18, K33, K34,
// K63-K65), <name>_f64 on PairLayout (K52-K56, K66-K68).
#define BOXTREE_TORCH_HELMHOLTZ2D_ENTRIES(suffix, L)                         \
  extern "C" int p2p_helmholtz2d_##suffix(                                   \
      const void* targets, long long ntargets, const void* sources,          \
      long long nsources, const void* charges, const void* bts,              \
      const void* btc, const void* bss, const void* bsc,                     \
      const void* target_boxes, long long nrows, const void* starts,         \
      const void* lists, double k, void* out, void* stream) {                \
    return boxtree_torch::p2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, sources, nsources, charges, bts, btc, bss, bsc,   \
        target_boxes, nrows, starts, lists, k, out, stream);                 \
  }                                                                          \
  extern "C" int m2p_helmholtz2d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,              \
      const void* btc, const void* rows, long long nrows,                    \
      const void* starts, const void* lists, const void* mpoles,             \
      const void* centers, long long nboxes, const void* box_scale,          \
      double k, long long order, long long nstart, long long grid,           \
      void* scratch, void* counter, void* out, void* stream) {               \
    return boxtree_torch::m2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, bts, btc, rows, nrows, starts, lists, mpoles,     \
        centers, nboxes, box_scale, k, order, nstart, grid, scratch,         \
        counter, out, stream);                                               \
  }                                                                          \
  extern "C" int p2l_helmholtz2d_##suffix(                                   \
      const void* sources, long long nsources, const void* charges,          \
      const void* bss, const void* bsc, const void* rows, long long nrows,   \
      const void* starts, const void* lists, const void* centers,            \
      long long nboxes, const void* box_scale, double k, long long order,    \
      long long nstart, long long grid, void* scratch, void* counter,        \
      void* out, void* stream) {                                             \
    return boxtree_torch::p2l_launch<boxtree_torch::L>(                      \
        sources, nsources, charges, bss, bsc, rows, nrows, starts, lists,    \
        centers, nboxes, box_scale, k, order, nstart, grid, scratch,         \
        counter, out, stream);                                               \
  }                                                                          \
  extern "C" int p2m_helmholtz2d_##suffix(                                   \
      const void* sources, long long nsources, const void* charges,          \
      const void* bss, const void* bsc, const void* rows, long long nrows,   \
      const void* centers, long long nboxes, const void* box_scale,          \
      double k, long long order, long long nstart, long long grid,           \
      void* scratch, void* counter, void* out, void* stream) {               \
    return boxtree_torch::p2m_launch<boxtree_torch::L>(                      \
        sources, nsources, charges, bss, bsc, rows, nrows, centers, nboxes,  \
        box_scale, k, order, nstart, grid, scratch, counter, out, stream);   \
  }                                                                          \
  extern "C" int l2p_helmholtz2d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,              \
      const void* btc, const void* rows, long long nrows, const void* locs,  \
      const void* centers, long long nboxes, const void* box_scale,          \
      double k, long long order, long long nstart, long long grid,           \
      void* scratch, void* counter, void* out, void* stream) {               \
    return boxtree_torch::l2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, bts, btc, rows, nrows, locs, centers, nboxes,     \
        box_scale, k, order, nstart, grid, scratch, counter, out, stream);   \
  }                                                                          \
  extern "C" int p2p_helmholtz2d_dipole_##suffix(                            \
      const void* targets, long long ntargets, const void* sources,          \
      long long nsources, const void* charges, const void* dipoles,          \
      const void* bts, const void* btc, const void* bss, const void* bsc,    \
      const void* target_boxes, long long nrows, const void* starts,         \
      const void* lists, double k, void* out, void* stream) {                \
    return boxtree_torch::p2p_dipole_launch<boxtree_torch::L>(               \
        targets, ntargets, sources, nsources, charges, dipoles, bts, btc,    \
        bss, bsc, target_boxes, nrows, starts, lists, k, out, stream);       \
  }                                                                          \
  extern "C" int p2l_helmholtz2d_dipole_##suffix(                            \
      const void* sources, long long nsources, const void* charges,          \
      const void* dipoles, const void* bss, const void* bsc,                 \
      const void* rows, long long nrows, const void* starts,                 \
      const void* lists, const void* centers, long long nboxes,              \
      const void* box_scale, double k, long long order, long long nstart,    \
      long long grid, void* scratch, void* counter, void* out,               \
      void* stream) {                                                        \
    return boxtree_torch::p2l_dipole_launch<boxtree_torch::L>(               \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, starts,  \
        lists, centers, nboxes, box_scale, k, order, nstart, grid, scratch,  \
        counter, out, stream);                                               \
  }                                                                          \
  extern "C" int p2m_helmholtz2d_dipole_##suffix(                            \
      const void* sources, long long nsources, const void* charges,          \
      const void* dipoles, const void* bss, const void* bsc,                 \
      const void* rows, long long nrows, const void* centers,                \
      long long nboxes, const void* box_scale, double k, long long order,    \
      long long nstart, long long grid, void* scratch, void* counter,        \
      void* out, void* stream) {                                             \
    return boxtree_torch::p2m_dipole_launch<boxtree_torch::L>(               \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, centers, \
        nboxes, box_scale, k, order, nstart, grid, scratch, counter, out,    \
        stream);                                                             \
  }

BOXTREE_TORCH_HELMHOLTZ2D_ENTRIES(c128, C128Layout)
BOXTREE_TORCH_HELMHOLTZ2D_ENTRIES(f64, PairLayout)
