// K9-K11 and K31-K32: the particle stages of the 3D Helmholtz FMM, kernel
// G(t, s) = exp(ik|t - s|) / |t - s| for a real wavenumber k, in double
// precision.  Each kernel is a template over the layout of its charges,
// weights and coefficients (helmholtz_layout.cuh): the _c128 entry points
// take complex128 (interleaved re, im) charges and coefficients, the _f64
// entry points, K47-K51, real charges and [re | im] rows, as the real-pair
// wrangler keeps them (boxtree_tpu/models/helmholtz3d.py:373
// Helmholtz3DPairsExpansionWrangler; its hooks _p2p :513, _m2p_eval :478,
// _p2l_terms :494, _p2m_terms :442 and _l2p_eval :461 compute the same
// functions in pair lanes).  Potentials are (n, 2) doubles in both.
//
// K47 p2p_helmholtz3d_f64, K48 m2p_helmholtz3d_f64, K49
// p2l_helmholtz3d_f64, K50 p2m_helmholtz3d_f64 and K51 l2p_helmholtz3d_f64
// are K9, K10, K11, K31 and K32 on the pair layout: a real charge enters
// the kernels' double2 slot as (q, 0), the weight w_nm = i w_c as (0,
// w_c), M2P and L2P stage the box's [re | im] row into the same double2
// shared array from its two planes, and P2M and P2L store or add their
// sums into the two planes.  The inner loops are the same code.
//
// K9  p2p_helmholtz3d: List-1 potentials, phi(t) = sum q_s exp(ik r) / r,
//     r = 0 skipped.  Replaces boxtree_tpu/models/expansion_base.py:1258
//     _eval_direct_rowmajor with boxtree_tpu/models/helmholtz3d.py:362
//     _p2p.
// K10 m2p_helmholtz3d: List-3 potentials from the multipoles of the listed
//     source boxes, phi(t) += sum_nm M_nm h_n(k r) s^n A_n^m(u) with
//     r u = ((t - c) / s) s, 0 at r = 0.  Replaces expansion_base.py:1440
//     _eval_multipoles_rowmajor with helmholtz3d.py:341 _m2p_eval (and
//     ops/spherical_bessel.py:29,60).
// K11 p2l_helmholtz3d: List-4 local expansions, L_nm(b) += sum q_s w_nm
//     h_n(k r) s^n conj(A_n^m(u)) with r u = ((x_s - c_b) / s) s, added in
//     place into the box's coefficients.  Replaces expansion_base.py:1629
//     _form_locals_rowmajor with helmholtz3d.py:351 _p2l_terms.
// K31 p2m_helmholtz3d: multipoles, M_nm(b) = sum q_s w_nm j_n(k r) s^-n
//     conj(A_n^m(u)) with r u = ((x_s - c_b) / s) s, over the sources box b
//     owns itself (its nonchild range, on any level), written once into the
//     box's row; a source at the centre adds q w_00 to M_00 alone.
//     Replaces expansion_base.py:652 form_multipoles with helmholtz3d.py:316
//     _p2m_terms.
// K32 l2p_helmholtz3d: phi(t) = sum_nm L_nm(b) j_n(k r) s^-n A_n^m(u) for
//     every target box b owns itself, written once; L_00(b) at r = 0.
//     Replaces expansion_base.py:1793 eval_locals with helmholtz3d.py:330
//     _l2p_eval.
//
// A_n^m are the regular solid harmonics of the unit direction
// (harmonics.cuh), h_n = j_n + i y_n the spherical Hankel functions
// (bessel.cuh), s the box's rscale and w_nm = 4 pi i k D_nm^2 (given by the
// wrapper).  As in the Laplace kernels (p2p.cu, m2p.cu, p2l.cu), a box's
// nonchild particles are the contiguous tree-order range
// [box_*_starts, + box_*_counts_nonchild), rows of the CSR lists name boxes,
// and one CTA (one warp) serves one row.
//
// Bound: float64 arithmetic.  K9 costs ~25 flops and a double sincos, sqrt
// and divide per pair, against 16 bytes of shared memory.  K10 and K11
// evaluate, per (particle, box) pair, the Bessel recurrences (p + 25
// double divides down, p steps up) and the order-p harmonics, and fold
// them into (p+1)^2 complex coefficients: ~3,000 flops per pair at p = 12,
// against one read of a 2.7 KB multipole (K10) or one warp's shuffle
// reductions (K11).  The harmonics never leave registers; each thread's
// h_n s^n table sits in shared memory (one column per thread), so no
// (particles x coefficients) array is stored and nothing spills.  K31 and
// K32 run per particle the j_n recurrence (p + 25 divides down, p products
// up) and the order-p harmonics against the box's (p+1)^2 coefficients,
// ~2,000 flops at p = 12; the bytes they must move are each particle once
// and each box's row once (~0.4 GB at 1e6 points, order 12, ~0.13 ms).  As
// K28 / K30 (p2m.cu, l2p.cu) do: one CTA (one warp) per box that owns
// particles; K31 sums each coefficient over the warp with shuffles as the
// harmonics come, lane 0 adds it to the box's row in shared memory, and
// the row is stored once (times w_nm s^-n), so there are no atomics; K32
// stages the box's row in shared memory and each lane folds its target's
// basis into it.
//
// The dipole kernels: sources of weight q and dipole d, the potential q (d .
// grad_y) G(x, y).  Each is the JVP in the source positions along d of a
// charge kernel above, its loop written once on dual.cuh's Dual<double>
// (bessel.cuh's recurrences and harmonics.cuh's regular harmonics run on
// duals; only the tangents are summed), on both layouts: K57-K59 the _c128
// entry points, K60-K62 the _f64 ones (real charges, [re | im] rows).
// K57 / K60 p2m_helmholtz3d_dipole: K31 on duals; replaces the jax.jvp of
//     helmholtz3d.py:316 _p2m_terms (pairs :442) at
//     expansion_base.py:664-673.  The tangent of the offset is d / s times
//     s, as the reference hands the hook d / s.  A source at its box's
//     centre adds the limit of that tangent as r -> 0, (k / 3) q conj(
//     R_1^m(d)) at n = 1 (times w_1m s^-1), where the reference's r = 0
//     guard gives 0.  j_0's tangent is -j_1 (bessel.cuh), where the
//     reference's quotient rule left its n = 0 column 2e-12 apart from
//     the twin's at the 1e6 sphere's k r.
// K58 / K61 p2p_helmholtz3d_dipole: K9 on duals, the dipole as three more
//     shared lanes; replaces the jax.jvp of helmholtz3d.py:362 _p2p (pairs
//     :513) at expansion_base.py:1314-1324 and :1350-1360; r = 0 skipped.
// K59 / K62 p2l_helmholtz3d_dipole: K11 on duals, its h_n s^n column a
//     Cx<Dual<double>> (32 bytes a value); replaces the jax.jvp of
//     helmholtz3d.py:351 _p2l_terms (pairs :494) at expansion_base.py:
//     1688-1694 and :1747-1764; 0 at r = 0, as the reference's guard.
// Bound: float64 arithmetic, as their charge kernels, each operation
// carrying a tangent (roughly twice the flops a pair; K59's table twice
// the shared memory, so fewer CTAs an SM).  The design keeps their
// charge kernels' own: one warp a row, CSR particle ranges, no atomics,
// nothing stored per (particle, coefficient).
#include "bessel.cuh"
#include "harmonics.cuh"
#include "helmholtz_layout.cuh"

namespace boxtree_torch {
namespace {

constexpr int kHelmThreads = 32;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// {{{ K9

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
p2p_helmholtz3d_kernel(const double* __restrict__ targets,
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
  __shared__ double sx[kHelmThreads], sy[kHelmThreads], sz[kHelmThreads];
  __shared__ double2 sq[kHelmThreads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kHelmThreads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    double tx = 0.0, ty = 0.0, tz = 0.0;
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
      tz = targets[2 * ntargets + t0 + ti];
    }
    double ar = 0.0, ai = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kHelmThreads) {
        const int cnt = min(kHelmThreads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sz[threadIdx.x] = sources[2 * nsources + s];
          sq[threadIdx.x] = L::charge(charges, s);
        }
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const double dx = tx - sx[j], dy = ty - sy[j], dz = tz - sz[j];
          const double r2 = dx * dx + dy * dy + dz * dz;
          if (r2 > 0.0) {
            const double r = sqrt(r2);
            double sn, cs;
            sincos(k * r, &sn, &cs);
            const double2 g = make_double2(cs / r, sn / r);
            const double2 v = cmul(g, sq[j]);
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

// {{{ K10

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
m2p_helmholtz3d_kernel(const double* __restrict__ targets,
                       long long ntargets,
                       const int* __restrict__ box_target_starts,
                       const int* __restrict__ box_target_counts,
                       const int* __restrict__ rows,
                       const int* __restrict__ starts,
                       const int* __restrict__ lists,
                       const double* __restrict__ mpoles,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       double2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* smp = reinterpret_cast<double2*>(smem_raw);       // nc
  double2* rad = smp + nc;                                    // (p+1) x warp
  double* geo = reinterpret_cast<double*>(rad + (p + 1) * kHelmThreads);
  const int lane = threadIdx.x;
  const int tbox = rows[blockIdx.x];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];

  for (int tb = 0; tb < nt; tb += kHelmThreads) {
    const int ti = tb + lane;
    const bool active = ti < nt;
    double tx = 0.0, ty = 0.0, tz = 0.0;
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
      tz = targets[2 * ntargets + t0 + ti];
    }
    double ar = 0.0, ai = 0.0;
    for (int e = e0; e < e1; ++e) {
      const long long sbox = lists[e];
      __syncthreads();
      for (int i = lane; i < nc; i += kHelmThreads)
        smp[i] = L::load(mpoles, sbox, nc, i);
      if (lane == 0) {
        geo[0] = centers[sbox];
        geo[1] = centers[nboxes + sbox];
        geo[2] = centers[2 * nboxes + sbox];
        geo[3] = box_scale[sbox];
      }
      __syncthreads();
      if (!active) continue;
      // the reference's hook receives (t - c) / s and works on that times s
      const double s = geo[3];
      const double x = (tx - geo[0]) / s * s;
      const double y = (ty - geo[1]) / s * s;
      const double z = (tz - geo[2]) / s * s;
      const double r2 = x * x + y * y + z * z;
      if (!(r2 > 0.0)) continue;
      const double r = sqrt(r2);
      spherical_hn1_scaled(k * r, s, p, rad + lane, kHelmThreads);
      double vr = 0.0, vi = 0.0;
      regular_pairs_foreach(
          x / r, y / r, z / r, p, [&](int n, int m, double a_r, double a_i) {
            const double2 h = rad[n * kHelmThreads + lane];
            // M_{n,m} h A_n^m
            const double2 b = cmul(h, make_double2(a_r, a_i));
            const double2 mp = smp[n * n + n + m];
            vr += mp.x * b.x - mp.y * b.y;
            vi += mp.x * b.y + mp.y * b.x;
            if (m > 0) {
              // A_n^{-m} = (-1)^m conj(A_n^m)
              const double sg = (m & 1) ? -1.0 : 1.0;
              const double2 c = cmul(h, make_double2(sg * a_r, -sg * a_i));
              const double2 mq = smp[n * n + n - m];
              vr += mq.x * c.x - mq.y * c.y;
              vi += mq.x * c.y + mq.y * c.x;
            }
          });
      ar += vr;
      ai += vi;
    }
    if (active) out[t0 + ti] = make_double2(ar, ai);
  }
}

// }}}

// {{{ K11

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
p2l_helmholtz3d_kernel(const double* __restrict__ sources,
                       long long nsources,
                       const typename L::Charge* __restrict__ charges,
                       const int* __restrict__ box_source_starts,
                       const int* __restrict__ box_source_counts,
                       const int* __restrict__ rows,
                       const int* __restrict__ starts,
                       const int* __restrict__ lists,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale,
                       const typename L::Weight* __restrict__ w_nm,
                       double k, int p, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* acc = reinterpret_cast<double2*>(smem_raw);       // nc
  double2* rad = acc + nc;                                    // (p+1) x warp
  const int lane = threadIdx.x;
  const long long tbox = rows[blockIdx.x];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];
  for (int i = lane; i < nc; i += kHelmThreads) acc[i] = make_double2(0, 0);
  const double cx = centers[tbox], cy = centers[nboxes + tbox],
               cz = centers[2 * nboxes + tbox];
  const double s = box_scale[tbox];
  __syncwarp();

  for (int e = e0; e < e1; ++e) {
    const int sbox = lists[e];
    const long long s0 = box_source_starts[sbox];
    const int ns = box_source_counts[sbox];
    for (int sb = 0; sb < ns; sb += kHelmThreads) {
      const int j = sb + lane;
      // idle lanes and r = 0 evaluate at direction (0, 0, 1), k r = 1,
      // with zero weight
      double ux = 0.0, uy = 0.0, uz = 1.0, kr = 1.0;
      double2 q = make_double2(0.0, 0.0);
      if (j < ns) {
        const double x = (sources[s0 + j] - cx) / s * s;
        const double y = (sources[nsources + s0 + j] - cy) / s * s;
        const double z = (sources[2 * nsources + s0 + j] - cz) / s * s;
        const double r2 = x * x + y * y + z * z;
        if (r2 > 0.0) {
          const double r = sqrt(r2);
          ux = x / r;
          uy = y / r;
          uz = z / r;
          kr = k * r;
          q = L::charge(charges, s0 + j);
        }
      }
      spherical_hn1_scaled(kr, s, p, rad + lane, kHelmThreads);
      regular_pairs_foreach(
          ux, uy, uz, p, [&](int n, int m, double a_r, double a_i) {
            const double2 h = rad[n * kHelmThreads + lane];
            // q h conj(A_n^m), summed over the warp
            const double2 t = cmul(q, cmul(h, make_double2(a_r, -a_i)));
            const double2 v = make_double2(warp_sum(t.x), warp_sum(t.y));
            double2 v2 = make_double2(0.0, 0.0);
            if (m > 0) {
              // conj(A_n^{-m}) = (-1)^m A_n^m
              const double sg = (m & 1) ? -1.0 : 1.0;
              const double2 t2 =
                  cmul(q, cmul(h, make_double2(sg * a_r, sg * a_i)));
              v2 = make_double2(warp_sum(t2.x), warp_sum(t2.y));
            }
            if (lane == 0) {
              const int i = n * n + n + m;
              const double2 wv = cmul(L::weight(w_nm, i), v);
              acc[i].x += wv.x;
              acc[i].y += wv.y;
              if (m > 0) {
                const int i2 = n * n + n - m;
                const double2 wv2 = cmul(L::weight(w_nm, i2), v2);
                acc[i2].x += wv2.x;
                acc[i2].y += wv2.y;
              }
            }
          });
    }
  }
  __syncwarp();
  for (int i = lane; i < nc; i += kHelmThreads)
    L::add(out, tbox, nc, i, acc[i]);
}

// }}}

// {{{ K31

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
p2m_helmholtz3d_kernel(const double* __restrict__ sources,
                       long long nsources,
                       const typename L::Charge* __restrict__ charges,
                       const int* __restrict__ box_source_starts,
                       const int* __restrict__ box_source_counts,
                       const int* __restrict__ rows,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale,
                       const typename L::Weight* __restrict__ w_nm,
                       double k, int p, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* acc = reinterpret_cast<double2*>(smem_raw);        // nc
  double* jt = reinterpret_cast<double*>(acc + nc);           // (p+1) x warp
  const int lane = threadIdx.x;
  const long long box = rows[blockIdx.x];
  const long long s0 = box_source_starts[box];
  const int ns = box_source_counts[box];
  for (int i = lane; i < nc; i += kHelmThreads) acc[i] = make_double2(0, 0);
  const double cx = centers[box], cy = centers[nboxes + box],
               cz = centers[2 * nboxes + box];
  const double s = box_scale[box];
  __syncwarp();

  for (int sb = 0; sb < ns; sb += kHelmThreads) {
    const int j = sb + lane;
    // idle lanes and r = 0 evaluate at direction (0, 0, 1) with k r = 0:
    // j_n(0) = [n == 0] and A_0^0 = 1, so a source at the centre adds q to
    // coefficient 0 alone (the reference's zero limit); idle lanes carry
    // no charge
    double ux = 0.0, uy = 0.0, uz = 1.0, kr = 0.0;
    double2 q = make_double2(0.0, 0.0);
    if (j < ns) {
      const double x = (sources[s0 + j] - cx) / s * s;
      const double y = (sources[nsources + s0 + j] - cy) / s * s;
      const double z = (sources[2 * nsources + s0 + j] - cz) / s * s;
      const double r2 = x * x + y * y + z * z;
      q = L::charge(charges, s0 + j);
      if (r2 > 0.0) {
        const double r = sqrt(r2);
        ux = x / r;
        uy = y / r;
        uz = z / r;
        kr = k * r;
      }
    }
    spherical_jn(kr, p, jt + lane, kHelmThreads);
    regular_pairs_foreach(
        ux, uy, uz, p, [&](int n, int m, double a_r, double a_i) {
          const double jn = jt[n * kHelmThreads + lane];
          // q j_n conj(A_n^m), summed over the warp
          const double2 t = cmul(q, make_double2(jn * a_r, -(jn * a_i)));
          const double vr = warp_sum(t.x), vi = warp_sum(t.y);
          double ur = 0.0, ui = 0.0;
          if (m > 0) {
            // conj(A_n^{-m}) = (-1)^m A_n^m
            const double sj = (m & 1) ? -jn : jn;
            const double2 t2 = cmul(q, make_double2(sj * a_r, sj * a_i));
            ur = warp_sum(t2.x);
            ui = warp_sum(t2.y);
          }
          if (lane == 0) {
            const int i = n * n + n + m;
            acc[i].x += vr;
            acc[i].y += vi;
            if (m > 0) {
              acc[i - 2 * m].x += ur;
              acc[i - 2 * m].y += ui;
            }
          }
        });
  }
  __syncwarp();
  for (int i = lane; i < nc; i += kHelmThreads) {
    int n = (int)sqrt((double)i);
    while (n * n > i) --n;
    while ((n + 1) * (n + 1) <= i) ++n;
    const double pw = pow(s, -double(n));
    L::store(out, box, nc, i,
             cmul(L::weight(w_nm, i),
                  make_double2(acc[i].x * pw, acc[i].y * pw)));
  }
}

// }}}

// {{{ K32

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
l2p_helmholtz3d_kernel(const double* __restrict__ targets,
                       long long ntargets,
                       const int* __restrict__ box_target_starts,
                       const int* __restrict__ box_target_counts,
                       const int* __restrict__ rows,
                       const double* __restrict__ locs,
                       const double* __restrict__ centers, long long nboxes,
                       const double* __restrict__ box_scale, double k, int p,
                       double2* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* sl = reinterpret_cast<double2*>(smem_raw);         // nc
  double* jt = reinterpret_cast<double*>(sl + nc);            // (p+1) x warp
  double* geo = jt + (p + 1) * kHelmThreads;                  // centre, s
  const int lane = threadIdx.x;
  const long long box = rows[blockIdx.x];
  const long long t0 = box_target_starts[box];
  const int nt = box_target_counts[box];
  for (int i = lane; i < nc; i += kHelmThreads)
    sl[i] = L::load(locs, box, nc, i);
  if (lane == 0) {
    geo[0] = centers[box];
    geo[1] = centers[nboxes + box];
    geo[2] = centers[2 * nboxes + box];
    geo[3] = box_scale[box];
  }
  __syncthreads();
  const double s = geo[3];

  for (int ti = lane; ti < nt; ti += kHelmThreads) {
    const double x = (targets[t0 + ti] - geo[0]) / s * s;
    const double y = (targets[ntargets + t0 + ti] - geo[1]) / s * s;
    const double z = (targets[2 * ntargets + t0 + ti] - geo[2]) / s * s;
    const double r2 = x * x + y * y + z * z;
    if (!(r2 > 0.0)) {
      out[t0 + ti] = sl[0];
      continue;
    }
    const double r = sqrt(r2);
    double* jl = jt + lane;
    spherical_jn(k * r, p, jl, kHelmThreads);
    // j_n s^-n
    for (int n = 0; n <= p; ++n)
      jl[n * kHelmThreads] *= pow(s, -double(n));
    double vr = 0.0, vi = 0.0;
    regular_pairs_foreach(
        x / r, y / r, z / r, p, [&](int n, int m, double a_r, double a_i) {
          const double f = jl[n * kHelmThreads];
          // L_{n,m} j_n s^-n A_n^m
          const double br = f * a_r, bi = f * a_i;
          const double2 l = sl[n * n + n + m];
          vr += l.x * br - l.y * bi;
          vi += l.x * bi + l.y * br;
          if (m > 0) {
            // A_n^{-m} = (-1)^m conj(A_n^m)
            const double sf = (m & 1) ? -f : f;
            const double cr = sf * a_r, ci = -(sf * a_i);
            const double2 l2 = sl[n * n + n - m];
            vr += l2.x * cr - l2.y * ci;
            vi += l2.x * ci + l2.y * cr;
          }
        });
    out[t0 + ti] = make_double2(vr, vi);
  }
}

// }}}

// {{{ K57-K62: the dipole kernels

using D = Dual<double>;

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
p2p_helmholtz3d_dipole_kernel(
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
  __shared__ double sx[kHelmThreads], sy[kHelmThreads], sz[kHelmThreads];
  __shared__ double sdx[kHelmThreads], sdy[kHelmThreads], sdz[kHelmThreads];
  __shared__ double2 sq[kHelmThreads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kHelmThreads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    double tx = 0.0, ty = 0.0, tz = 0.0;
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
      tz = targets[2 * ntargets + t0 + ti];
    }
    double ar = 0.0, ai = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kHelmThreads) {
        const int cnt = min(kHelmThreads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sz[threadIdx.x] = sources[2 * nsources + s];
          sdx[threadIdx.x] = dipoles[s];
          sdy[threadIdx.x] = dipoles[nsources + s];
          sdz[threadIdx.x] = dipoles[2 * nsources + s];
          sq[threadIdx.x] = L::charge(charges, s);
        }
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const double dx = tx - sx[j], dy = ty - sy[j], dz = tz - sz[j];
          const double r2 = dx * dx + dy * dy + dz * dz;
          if (r2 > 0.0) {
            // t - s moves by -d as the source moves by d
            const D x(dx, -sdx[j]), y(dy, -sdy[j]), z(dz, -sdz[j]);
            const D r = sqrt_t(x * x + y * y + z * z);
            D sn, cs;
            sincos_t(k * r, &sn, &cs);
            // the tangent of exp(ik r) / r
            const double2 v =
                cmul(make_double2((cs / r).d, (sn / r).d), sq[j]);
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
__global__ void __launch_bounds__(kHelmThreads)
p2l_helmholtz3d_dipole_kernel(
    const double* __restrict__ sources, long long nsources,
    const typename L::Charge* __restrict__ charges,
    const double* __restrict__ dipoles,
    const int* __restrict__ box_source_starts,
    const int* __restrict__ box_source_counts, const int* __restrict__ rows,
    const int* __restrict__ starts, const int* __restrict__ lists,
    const double* __restrict__ centers, long long nboxes,
    const double* __restrict__ box_scale,
    const typename L::Weight* __restrict__ w_nm, double k, int p,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* acc = reinterpret_cast<double2*>(smem_raw);       // nc
  Cx<D>* rad = reinterpret_cast<Cx<D>*>(acc + nc);           // (p+1) x warp
  const int lane = threadIdx.x;
  const long long tbox = rows[blockIdx.x];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];
  for (int i = lane; i < nc; i += kHelmThreads) acc[i] = make_double2(0, 0);
  const double cx = centers[tbox], cy = centers[nboxes + tbox],
               cz = centers[2 * nboxes + tbox];
  const double s = box_scale[tbox];
  __syncwarp();

  for (int e = e0; e < e1; ++e) {
    const int sbox = lists[e];
    const long long s0 = box_source_starts[sbox];
    const int ns = box_source_counts[sbox];
    for (int sb = 0; sb < ns; sb += kHelmThreads) {
      const int j = sb + lane;
      // idle lanes and r = 0 evaluate at direction (0, 0, 1), k r = 1, with
      // zero tangents and zero weight (the reference's guard gives 0)
      D ux(0.0), uy(0.0), uz(1.0), kr(1.0);
      double2 q = make_double2(0.0, 0.0);
      if (j < ns) {
        const long long i = s0 + j;
        // the hook receives (x_s - c) / s and d / s, and works on them
        // times s
        const double x = (sources[i] - cx) / s * s;
        const double y = (sources[nsources + i] - cy) / s * s;
        const double z = (sources[2 * nsources + i] - cz) / s * s;
        if (x * x + y * y + z * z > 0.0) {
          const D X(x, dipoles[i] / s * s),
              Y(y, dipoles[nsources + i] / s * s),
              Z(z, dipoles[2 * nsources + i] / s * s);
          const D r = sqrt_t(X * X + Y * Y + Z * Z);
          ux = X / r;
          uy = Y / r;
          uz = Z / r;
          kr = k * r;
          q = L::charge(charges, i);
        }
      }
      spherical_hn1_scaled(kr, s, p, rad + lane, kHelmThreads);
      regular_pairs_foreach(ux, uy, uz, p, [&](int n, int m, D a_r, D a_i) {
        const Cx<D> h = rad[n * kHelmThreads + lane];
        // q times the tangent of h conj(A_n^m), summed over the warp
        const Cx<D> b = mul(h, Cx<D>{a_r, -a_i});
        const double2 t = cmul(q, make_double2(b.re.d, b.im.d));
        const double2 v = make_double2(warp_sum(t.x), warp_sum(t.y));
        double2 v2 = make_double2(0.0, 0.0);
        if (m > 0) {
          // conj(A_n^{-m}) = (-1)^m A_n^m
          const Cx<D> b2 = (m & 1) ? mul(h, Cx<D>{-a_r, -a_i})
                                   : mul(h, Cx<D>{a_r, a_i});
          const double2 t2 = cmul(q, make_double2(b2.re.d, b2.im.d));
          v2 = make_double2(warp_sum(t2.x), warp_sum(t2.y));
        }
        if (lane == 0) {
          const int i = n * n + n + m;
          const double2 wv = cmul(L::weight(w_nm, i), v);
          acc[i].x += wv.x;
          acc[i].y += wv.y;
          if (m > 0) {
            const int i2 = n * n + n - m;
            const double2 wv2 = cmul(L::weight(w_nm, i2), v2);
            acc[i2].x += wv2.x;
            acc[i2].y += wv2.y;
          }
        }
      });
    }
  }
  __syncwarp();
  for (int i = lane; i < nc; i += kHelmThreads)
    L::add(out, tbox, nc, i, acc[i]);
}

template <typename L>
__global__ void __launch_bounds__(kHelmThreads)
p2m_helmholtz3d_dipole_kernel(
    const double* __restrict__ sources, long long nsources,
    const typename L::Charge* __restrict__ charges,
    const double* __restrict__ dipoles,
    const int* __restrict__ box_source_starts,
    const int* __restrict__ box_source_counts, const int* __restrict__ rows,
    const double* __restrict__ centers, long long nboxes,
    const double* __restrict__ box_scale,
    const typename L::Weight* __restrict__ w_nm, double k, int p,
    double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (p + 1) * (p + 1);
  double2* acc = reinterpret_cast<double2*>(smem_raw);        // nc
  D* jt = reinterpret_cast<D*>(acc + nc);                      // (p+1) x warp
  const int lane = threadIdx.x;
  const long long box = rows[blockIdx.x];
  const long long s0 = box_source_starts[box];
  const int ns = box_source_counts[box];
  for (int i = lane; i < nc; i += kHelmThreads) acc[i] = make_double2(0, 0);
  const double cx = centers[box], cy = centers[nboxes + box],
               cz = centers[2 * nboxes + box];
  const double s = box_scale[box];
  __syncwarp();

  for (int sb = 0; sb < ns; sb += kHelmThreads) {
    const int j = sb + lane;
    // idle lanes and r = 0 run the loop at direction (0, 0, 1), k r = 0,
    // with zero tangents and zero weight; a source at the centre adds the
    // limit of the tangent as r -> 0 instead, (k / 3) q conj(R_1^m(d)) at
    // n = 1 alone (j_1(k r) A_1^m(u) -> (k / 3) R_1^m(x), R_1^0 = z,
    // R_1^1 = (x + iy) / 2, R_1^{-1} = -(x - iy) / 2)
    D ux(0.0), uy(0.0), uz(1.0), kr(0.0);
    double2 q = make_double2(0.0, 0.0);
    double2 lim0 = q, limp = q, limm = q;
    if (j < ns) {
      const long long i = s0 + j;
      const double x = (sources[i] - cx) / s * s;
      const double y = (sources[nsources + i] - cy) / s * s;
      const double z = (sources[2 * nsources + i] - cz) / s * s;
      const double dx = dipoles[i] / s * s;
      const double dy = dipoles[nsources + i] / s * s;
      const double dz = dipoles[2 * nsources + i] / s * s;
      const double2 qi = L::charge(charges, i);
      if (x * x + y * y + z * z > 0.0) {
        const D X(x, dx), Y(y, dy), Z(z, dz);
        const D r = sqrt_t(X * X + Y * Y + Z * Z);
        ux = X / r;
        uy = Y / r;
        uz = Z / r;
        kr = k * r;
        q = qi;
      } else {
        const double f = k / 3.0;
        lim0 = cmul(qi, make_double2(f * dz, 0.0));
        limp = cmul(qi, make_double2(0.5 * f * dx, -(0.5 * f * dy)));
        limm = cmul(qi, make_double2(-(0.5 * f * dx), -(0.5 * f * dy)));
      }
    }
    spherical_jn(kr, p, jt + lane, kHelmThreads);
    regular_pairs_foreach(ux, uy, uz, p, [&](int n, int m, D a_r, D a_i) {
      const D jn = jt[n * kHelmThreads + lane];
      // q times the tangent of j_n conj(A_n^m), summed over the warp
      double2 t = cmul(q, make_double2((jn * a_r).d, -(jn * a_i).d));
      if (n == 1) {
        const double2 l = m == 0 ? lim0 : limp;
        t.x += l.x;
        t.y += l.y;
      }
      const double vr = warp_sum(t.x), vi = warp_sum(t.y);
      double ur = 0.0, ui = 0.0;
      if (m > 0) {
        // conj(A_n^{-m}) = (-1)^m A_n^m
        const D sj = (m & 1) ? -jn : jn;
        double2 t2 = cmul(q, make_double2((sj * a_r).d, (sj * a_i).d));
        if (n == 1) {
          t2.x += limm.x;
          t2.y += limm.y;
        }
        ur = warp_sum(t2.x);
        ui = warp_sum(t2.y);
      }
      if (lane == 0) {
        const int i = n * n + n + m;
        acc[i].x += vr;
        acc[i].y += vi;
        if (m > 0) {
          acc[i - 2 * m].x += ur;
          acc[i - 2 * m].y += ui;
        }
      }
    });
  }
  __syncwarp();
  for (int i = lane; i < nc; i += kHelmThreads) {
    int n = (int)sqrt((double)i);
    while (n * n > i) --n;
    while ((n + 1) * (n + 1) <= i) ++n;
    const double pw = pow(s, -double(n));
    L::store(out, box, nc, i,
             cmul(L::weight(w_nm, i),
                  make_double2(acc[i].x * pw, acc[i].y * pw)));
  }
}

// }}}

size_t helmholtz_smem(long long order) {
  return ((order + 1) * (order + 1) + (order + 1) * kHelmThreads) *
             sizeof(double2) +
         4 * sizeof(double);
}

// K31 (K32 takes 4 doubles more): the box's row and a j_n table a lane
size_t p2m_l2p_smem(long long order) {
  return (order + 1) * (order + 1) * sizeof(double2) +
         (order + 1) * kHelmThreads * sizeof(double);
}

// K62 / K59 (the dipole P2L): the box's row and an h_n s^n dual table a
// lane; K57 / K60 (the dipole P2M): the row and a j_n dual table a lane
size_t p2l_dipole_smem(long long order) {
  return (order + 1) * (order + 1) * sizeof(double2) +
         (order + 1) * kHelmThreads * sizeof(Cx<D>);
}
size_t p2m_dipole_smem(long long order) {
  return (order + 1) * (order + 1) * sizeof(double2) +
         (order + 1) * kHelmThreads * sizeof(D);
}

// {{{ launches, one per kernel and layout

template <typename L>
int p2p_launch(const void* targets, long long ntargets, const void* sources,
               long long nsources, const void* charges, const void* bts,
               const void* btc, const void* bss, const void* bsc,
               const void* target_boxes, long long nrows, const void* starts,
               const void* lists, double k, void* out, void* stream) {
  if (nrows > 0) {
    p2p_helmholtz3d_kernel<L><<<(unsigned)nrows, kHelmThreads, 0,
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bts,
        (const int*)btc, (const int*)bss, (const int*)bsc,
        (const int*)target_boxes, (const int*)starts, (const int*)lists, k,
        (double2*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int m2p_launch(const void* targets, long long ntargets, const void* bts,
               const void* btc, const void* rows, long long nrows,
               const void* starts, const void* lists, const void* mpoles,
               const void* centers, long long nboxes, const void* box_scale,
               double k, long long order, void* out, void* stream) {
  if (nrows > 0) {
    m2p_helmholtz3d_kernel<L><<<(unsigned)nrows, kHelmThreads,
                                helmholtz_smem(order),
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, (const int*)starts, (const int*)lists,
        (const double*)mpoles, (const double*)centers, nboxes,
        (const double*)box_scale, k, (int)order, (double2*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2l_launch(const void* sources, long long nsources, const void* charges,
               const void* bss, const void* bsc, const void* rows,
               long long nrows, const void* starts, const void* lists,
               const void* centers, long long nboxes, const void* box_scale,
               const void* w_nm, double k, long long order, void* out,
               void* stream) {
  if (nrows > 0) {
    p2l_helmholtz3d_kernel<L><<<(unsigned)nrows, kHelmThreads,
                                helmholtz_smem(order),
                                (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bss,
        (const int*)bsc, (const int*)rows, (const int*)starts,
        (const int*)lists, (const double*)centers, nboxes,
        (const double*)box_scale, (const typename L::Weight*)w_nm, k,
        (int)order, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2m_launch(const void* sources, long long nsources, const void* charges,
               const void* bss, const void* bsc, const void* rows,
               long long nrows, const void* centers, long long nboxes,
               const void* box_scale, const void* w_nm, double k,
               long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = p2m_l2p_smem(order);
    const cudaError_t err = allow_smem(p2m_helmholtz3d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_helmholtz3d_kernel<L><<<(unsigned)nrows, kHelmThreads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const int*)bss,
        (const int*)bsc, (const int*)rows, (const double*)centers, nboxes,
        (const double*)box_scale, (const typename L::Weight*)w_nm, k,
        (int)order, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int l2p_launch(const void* targets, long long ntargets, const void* bts,
               const void* btc, const void* rows, long long nrows,
               const void* locs, const void* centers, long long nboxes,
               const void* box_scale, double k, long long order, void* out,
               void* stream) {
  if (nrows > 0) {
    const size_t smem = p2m_l2p_smem(order) + 4 * sizeof(double);
    const cudaError_t err = allow_smem(l2p_helmholtz3d_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    l2p_helmholtz3d_kernel<L><<<(unsigned)nrows, kHelmThreads, smem,
                                (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, (const double*)locs, (const double*)centers,
        nboxes, (const double*)box_scale, k, (int)order, (double2*)out);
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
    p2p_helmholtz3d_dipole_kernel<L><<<(unsigned)nrows, kHelmThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const double*)targets, ntargets, (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bts, (const int*)btc, (const int*)bss, (const int*)bsc,
        (const int*)target_boxes, (const int*)starts, (const int*)lists, k,
        (double2*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2l_dipole_launch(const void* sources, long long nsources,
                      const void* charges, const void* dipoles,
                      const void* bss, const void* bsc, const void* rows,
                      long long nrows, const void* starts, const void* lists,
                      const void* centers, long long nboxes,
                      const void* box_scale, const void* w_nm, double k,
                      long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = p2l_dipole_smem(order);
    const cudaError_t err =
        allow_smem(p2l_helmholtz3d_dipole_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2l_helmholtz3d_dipole_kernel<L><<<(unsigned)nrows, kHelmThreads, smem,
                                       (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows,
        (const int*)starts, (const int*)lists, (const double*)centers,
        nboxes, (const double*)box_scale, (const typename L::Weight*)w_nm, k,
        (int)order, (double*)out);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int p2m_dipole_launch(const void* sources, long long nsources,
                      const void* charges, const void* dipoles,
                      const void* bss, const void* bsc, const void* rows,
                      long long nrows, const void* centers, long long nboxes,
                      const void* box_scale, const void* w_nm, double k,
                      long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = p2m_dipole_smem(order);
    const cudaError_t err =
        allow_smem(p2m_helmholtz3d_dipole_kernel<L>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_helmholtz3d_dipole_kernel<L><<<(unsigned)nrows, kHelmThreads, smem,
                                       (cudaStream_t)stream>>>(
        (const double*)sources, nsources,
        (const typename L::Charge*)charges, (const double*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows,
        (const double*)centers, nboxes, (const double*)box_scale,
        (const typename L::Weight*)w_nm, k, (int)order, (double*)out);
  }
  return (int)cudaGetLastError();
}

// }}}

}  // namespace
}  // namespace boxtree_torch

// The C entry points: <name>_c128 on C128Layout (K9-K11, K31, K32, and
// the dipole kernels K57-K59), <name>_f64 on PairLayout (K47-K51, K60-K62).
#define BOXTREE_TORCH_HELMHOLTZ3D_ENTRIES(suffix, L)                         \
  extern "C" int p2p_helmholtz3d_##suffix(                                   \
      const void* targets, long long ntargets, const void* sources,          \
      long long nsources, const void* charges, const void* bts,              \
      const void* btc, const void* bss, const void* bsc,                     \
      const void* target_boxes, long long nrows, const void* starts,         \
      const void* lists, double k, void* out, void* stream) {                \
    return boxtree_torch::p2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, sources, nsources, charges, bts, btc, bss, bsc,   \
        target_boxes, nrows, starts, lists, k, out, stream);                 \
  }                                                                          \
  extern "C" int m2p_helmholtz3d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,              \
      const void* btc, const void* rows, long long nrows,                    \
      const void* starts, const void* lists, const void* mpoles,             \
      const void* centers, long long nboxes, const void* box_scale,          \
      double k, long long order, void* out, void* stream) {                  \
    return boxtree_torch::m2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, bts, btc, rows, nrows, starts, lists, mpoles,     \
        centers, nboxes, box_scale, k, order, out, stream);                  \
  }                                                                          \
  extern "C" int p2l_helmholtz3d_##suffix(                                   \
      const void* sources, long long nsources, const void* charges,          \
      const void* bss, const void* bsc, const void* rows, long long nrows,   \
      const void* starts, const void* lists, const void* centers,            \
      long long nboxes, const void* box_scale, const void* w_nm, double k,   \
      long long order, void* out, void* stream) {                            \
    return boxtree_torch::p2l_launch<boxtree_torch::L>(                      \
        sources, nsources, charges, bss, bsc, rows, nrows, starts, lists,    \
        centers, nboxes, box_scale, w_nm, k, order, out, stream);            \
  }                                                                          \
  extern "C" int p2m_helmholtz3d_##suffix(                                   \
      const void* sources, long long nsources, const void* charges,          \
      const void* bss, const void* bsc, const void* rows, long long nrows,   \
      const void* centers, long long nboxes, const void* box_scale,          \
      const void* w_nm, double k, long long order, void* out,                \
      void* stream) {                                                        \
    return boxtree_torch::p2m_launch<boxtree_torch::L>(                      \
        sources, nsources, charges, bss, bsc, rows, nrows, centers, nboxes,  \
        box_scale, w_nm, k, order, out, stream);                             \
  }                                                                          \
  extern "C" int l2p_helmholtz3d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,              \
      const void* btc, const void* rows, long long nrows, const void* locs,  \
      const void* centers, long long nboxes, const void* box_scale,          \
      double k, long long order, void* out, void* stream) {                  \
    return boxtree_torch::l2p_launch<boxtree_torch::L>(                      \
        targets, ntargets, bts, btc, rows, nrows, locs, centers, nboxes,     \
        box_scale, k, order, out, stream);                                   \
  }                                                                          \
  extern "C" int p2p_helmholtz3d_dipole_##suffix(                            \
      const void* targets, long long ntargets, const void* sources,          \
      long long nsources, const void* charges, const void* dipoles,          \
      const void* bts, const void* btc, const void* bss, const void* bsc,    \
      const void* target_boxes, long long nrows, const void* starts,         \
      const void* lists, double k, void* out, void* stream) {                \
    return boxtree_torch::p2p_dipole_launch<boxtree_torch::L>(               \
        targets, ntargets, sources, nsources, charges, dipoles, bts, btc,    \
        bss, bsc, target_boxes, nrows, starts, lists, k, out, stream);       \
  }                                                                          \
  extern "C" int p2l_helmholtz3d_dipole_##suffix(                            \
      const void* sources, long long nsources, const void* charges,          \
      const void* dipoles, const void* bss, const void* bsc,                 \
      const void* rows, long long nrows, const void* starts,                 \
      const void* lists, const void* centers, long long nboxes,              \
      const void* box_scale, const void* w_nm, double k, long long order,    \
      void* out, void* stream) {                                             \
    return boxtree_torch::p2l_dipole_launch<boxtree_torch::L>(               \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, starts,  \
        lists, centers, nboxes, box_scale, w_nm, k, order, out, stream);     \
  }                                                                          \
  extern "C" int p2m_helmholtz3d_dipole_##suffix(                            \
      const void* sources, long long nsources, const void* charges,          \
      const void* dipoles, const void* bss, const void* bsc,                 \
      const void* rows, long long nrows, const void* centers,                \
      long long nboxes, const void* box_scale, const void* w_nm, double k,   \
      long long order, void* out, void* stream) {                            \
    return boxtree_torch::p2m_dipole_launch<boxtree_torch::L>(               \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, centers, \
        nboxes, box_scale, w_nm, k, order, out, stream);                     \
  }

BOXTREE_TORCH_HELMHOLTZ3D_ENTRIES(c128, C128Layout)
BOXTREE_TORCH_HELMHOLTZ3D_ENTRIES(f64, PairLayout)
