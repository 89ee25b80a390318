// K19-K21, K38-K42: the particle stages of the 2D Laplace FMM, kernel
// G(t, s) = log(t - s) (potential log |t - s|), with two coefficient
// layouts, each with its entry points:
//   _c128: p + 1 complex128 coefficients (interleaved re, im), complex
//          charges and potentials, float64 geometry (the complex wrangler);
//   _f32 / _f64: [re_0..re_p | im_0..im_p] real pair lanes, real charges
//          and potentials Re phi, geometry of the same type (the pairs
//          wrangler).
//
// K19 p2p_laplace2d: List-1 potentials, phi(t) = sum q_s (1/2) log r^2,
//     r = 0 skipped.  Replaces boxtree_tpu/models/expansion_base.py:1196
//     eval_direct (edges form :1341 for complex, row-major :1258 for pairs)
//     with boxtree_tpu/models/laplace.py:232 _p2p.
// K20 m2p_laplace2d: List-3 potentials from the multipoles of the listed
//     source boxes, phi(t) += a_0 (log w + log s) + sum_k a_k w^-k with
//     w = (t - c) / s.  Replaces expansion_base.py:1526 eval_multipoles
//     (:1546 edges, :1440 row-major) with laplace.py:210 _m2p_eval (pairs
//     :340).
// K21 p2l_laplace2d: List-4 local expansions, b_0 += q (log(-z0) + log s),
//     b_l += -q z0^-l / l with z0 = (y_s - c) / s, added in place into the
//     box's coefficients.  Replaces expansion_base.py:1719 form_locals
//     (:1733 edges, :1629 row-major) with laplace.py:221 _p2l_terms (pairs
//     :356).
//
// K38 p2m_laplace2d: multipoles of the sources each box owns itself (its
//     nonchild range, on any level), a_0 = sum q, a_k = -sum q zeta^k / k
//     with zeta = (y - c) / s, written once into the box's row.  Replaces
//     expansion_base.py:652 form_multipoles with laplace.py:191 _p2m_terms
//     (pairs :318).
// K39 p2m_laplace2d_dipole: K38's loop on Dual<T> in zeta, tangent d / s:
//     the reference's JVP of _p2m_terms (expansion_base.py:664-673).
// K40 l2p_laplace2d: phi(t) = sum_l L_l w^l, w = (t - c) / s, for every
//     target each box owns, written once; the pairs keep the real part
//     (laplace.py:329-338).  Replaces expansion_base.py:1793 eval_locals
//     with laplace.py:201 _l2p_eval.
// K41 p2p_laplace2d_dipole: K19 on Dual<T> in the source position along
//     the dipole, phi(t) = sum q_s d_s . (s - t) / |t - s|^2, 0 (value and
//     tangent) at r = 0 as the JVP through laplace.py:236-237's where.
//     Replaces the JVP of expansion_base.py:1314-1324 (:1350-1360).
// K42 p2l_laplace2d_dipole: K21 on Dual<T>, tangent d_s / s_b.  Replaces
//     the JVP of expansion_base.py:1688-1694 (:1747-1764).
//
// The edges follow each reference (boxtree_torch/ops/laplace2d.py says
// why): the complex forms hold a -0.0 imaginary offset as +0.0, take w = 1
// at w = 0 (M2P) and z0 = 1 at z0 = 0 (P2L, log(-1 - 0i) = -i pi); the
// pairs take the offset's sign as it is and 1/w = 0 at w = 0.  Under the
// JVP they part again at z0 = 0: the complex P2L's z0 = 1 is a constant,
// so K42 adds nothing there; the pairs replace only r^2 and atan2's x
// argument by constants, so the tangents of th and of 1 / z0 stay, and
// K42 keeps them.
//
// As in the other list kernels, a box's nonchild particles are the
// contiguous tree-order range [box_*_starts, + box_*_counts_nonchild),
// rows of the CSR lists name boxes, and one CTA (one warp) serves one row.
//
// Bound: arithmetic.  K19 costs one log and ~10 flops a pair (1.4e8 pairs
// on the 1e6-point path), its sources staged 32 at a time in shared
// memory; K20 and K21 cost a log, an atan2 and one complex multiply-add a
// coefficient per (particle, box) pair.  K20 keeps the listed box's
// multipole in shared memory, each lane one target.  K21 has each lane
// write its source's terms to a column of a shared table, then each lane
// sum the rows of the coefficients it owns: no shuffles, no atomics (as
// K18).  The table is ncoeffs x 33 values: 19,008 B at order 35 in
// complex128 or float64 pairs; past 48 KiB the launcher opts in.  K42
// stores only the tangents there, so it takes K21's shared memory.
//
// K38 / K39 (one warp a row of the boxes that own sources, as K28 / K33)
// run the power recurrence a source, lane by lane, and sum each
// coefficient across the warp with shuffles; lane 0 adds it to the box's
// accumulator in shared memory (2 (p + 1) values of T), stored to the
// box's row once: no atomics.  Bound: bytes (each source read once, each
// box's row written once), the recurrence and the warp sums being the
// work.  K40 (one warp a row of the boxes that own targets) stages the
// box's masked local row, centre and scale in shared memory; each lane
// evaluates one target's polynomial in the reference's order of powers.
// ptxas (sm_90a), registers f32 / f64 / c128: K38 42 / 55 / 60, K39 40 /
// 61 / 61, K40 52 / 60 / 59, K41 47 / 57 / 58, K42 44 / 64 / 68; no
// spills.
#include <type_traits>

#include "common.cuh"
#include "dual.cuh"

namespace boxtree_torch {
namespace {

constexpr int kL2Threads = 32;

// value type of the charges and potentials: the real type for pairs,
// double2 for complex128
template <typename V>
__device__ __forceinline__ V vzero() {
  return V(0);
}
template <>
__device__ __forceinline__ double2 vzero<double2>() {
  return make_double2(0.0, 0.0);
}

template <typename T>
__device__ __forceinline__ void vaxpy(T& acc, T g, T q) {
  acc += g * q;
}
__device__ __forceinline__ void vaxpy(double2& acc, double g, double2 q) {
  acc.x += g * q.x;
  acc.y += g * q.y;
}

__device__ __forceinline__ double2 mul_c(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// log of a complex value: (log |z|, arg z), arg honouring a signed zero
__device__ __forceinline__ double2 log_c(double2 z) {
  return make_double2(log(hypot(z.x, z.y)), atan2(z.y, z.x));
}

// 1 / z
__device__ __forceinline__ double2 inv_c(double2 z) {
  const double d = z.x * z.x + z.y * z.y;
  return make_double2(z.x / d, -z.y / d);
}

// the reference's complex offset rel[0] + 1j * rel[1]: -0.0 imaginary
// parts come out +0.0 (never contracted or folded away)
__device__ __forceinline__ double2 as_complex(double x, double y) {
  return make_double2(x, __dadd_rn(y, 0.0));
}

// {{{ K19, K41

template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kL2Threads)
p2p_laplace2d_kernel(const T* __restrict__ targets, long long ntargets,
                     const T* __restrict__ sources, long long nsources,
                     const V* __restrict__ charges,
                     const T* __restrict__ dipoles,
                     const int* __restrict__ box_target_starts,
                     const int* __restrict__ box_target_counts,
                     const int* __restrict__ box_source_starts,
                     const int* __restrict__ box_source_counts,
                     const int* __restrict__ target_boxes,
                     const int* __restrict__ starts,
                     const int* __restrict__ lists, V* __restrict__ out) {
  __shared__ T sx[kL2Threads], sy[kL2Threads];
  __shared__ T sdx[kDipole ? kL2Threads : 1], sdy[kDipole ? kL2Threads : 1];
  __shared__ V sq[kL2Threads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kL2Threads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    T tx = T(0), ty = T(0);
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
    }
    V acc = vzero<V>();
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kL2Threads) {
        const int cnt = min(kL2Threads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sq[threadIdx.x] = charges[s];
          if (kDipole) {
            sdx[threadIdx.x] = dipoles[s];
            sdy[threadIdx.x] = dipoles[nsources + s];
          }
        }
        __syncthreads();
        if (!active) continue;
        for (int j = 0; j < cnt; ++j) {
          if constexpr (kDipole) {
            // the offset moves against the source: tangent -d
            const Dual<T> dx(tx - sx[j], -sdx[j]), dy(ty - sy[j], -sdy[j]);
            const Dual<T> r2 = dx * dx + dy * dy;
            if (r2.v > T(0))
              vaxpy(acc, (Dual<T>(T(0.5), T(0)) * log_t(r2)).d, sq[j]);
          } else {
            const T dx = tx - sx[j], dy = ty - sy[j];
            const T r2 = dx * dx + dy * dy;
            if (r2 > T(0)) vaxpy(acc, T(0.5) * log_t(r2), sq[j]);
          }
        }
      }
    }
    if (active) out[t0 + ti] = acc;
  }
}

// }}}

// {{{ K20

// a_0 (log w + log s) + sum_k a_k w^-k, w = 0 taken as 1 (complex)
__device__ __forceinline__ double2 m2p_one(const double2* mp, int p,
                                           double x, double y, double s) {
  double2 w = as_complex(x, y);
  if (w.x == 0.0 && w.y == 0.0) w = make_double2(1.0, 0.0);
  double2 lw = log_c(w);
  lw.x += log(s);
  double2 acc = mul_c(mp[0], lw);
  const double2 winv = inv_c(w);
  double2 wp = make_double2(1.0, 0.0);
  for (int k = 1; k <= p; ++k) {
    wp = mul_c(wp, winv);
    const double2 t = mul_c(mp[k], wp);
    acc.x += t.x;
    acc.y += t.y;
  }
  return acc;
}

// Re of the same on pair lanes, 1/w = 0 at w = 0
template <typename T>
__device__ __forceinline__ T m2p_one(const T* mp, int p, T x, T y, T s) {
  const int nc = p + 1;
  const T r2 = x * x + y * y;
  const bool zero = r2 == T(0);
  const T r2s = zero ? T(1) : r2;
  const T lgr = T(0.5) * log_t(r2s) + log_t(s);
  const T th = atan2_t(y, zero ? T(1) : x);
  T acc = mp[0] * lgr - mp[nc] * th;
  const T ixr = x / r2s, ixi = -y / r2s;
  T pr = T(1), pi = T(0);
  for (int k = 1; k < nc; ++k) {
    const T nr = pr * ixr - pi * ixi;
    pi = pr * ixi + pi * ixr;
    pr = nr;
    acc += mp[k] * pr - mp[nc + k] * pi;
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void vadd(T& acc, T v) {
  acc += v;
}
__device__ __forceinline__ void vadd(double2& acc, double2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

template <typename T, typename V>
__global__ void __launch_bounds__(kL2Threads)
m2p_laplace2d_kernel(const T* __restrict__ targets, long long ntargets,
                     const int* __restrict__ box_target_starts,
                     const int* __restrict__ box_target_counts,
                     const int* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ lists,
                     const V* __restrict__ mpoles,
                     const T* __restrict__ centers, long long nboxes,
                     const T* __restrict__ box_scale, int p, int nc,
                     V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* smp = reinterpret_cast<V*>(smem_raw);                     // nc
  __shared__ T geo[3];                                         // cx, cy, s
  const int lane = threadIdx.x;
  const int tbox = rows[blockIdx.x];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];

  for (int tb = 0; tb < nt; tb += kL2Threads) {
    const int ti = tb + lane;
    const bool active = ti < nt;
    T tx = T(0), ty = T(0);
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
    }
    V acc = vzero<V>();
    for (int e = e0; e < e1; ++e) {
      const long long sbox = lists[e];
      __syncthreads();
      for (int i = lane; i < nc; i += kL2Threads)
        smp[i] = mpoles[sbox * nc + i];
      if (lane == 0) {
        geo[0] = centers[sbox];
        geo[1] = centers[nboxes + sbox];
        geo[2] = box_scale[sbox];
      }
      __syncthreads();
      if (!active) continue;
      const T s = geo[2];
      vadd(acc, m2p_one(smp, p, (tx - geo[0]) / s, (ty - geo[1]) / s, s));
    }
    if (active) out[t0 + ti] = acc;
  }
}

// }}}

// {{{ K21, K42

// source j's p + 1 complex terms into column `lane` of `terms`; z0 = 0
// taken as 1
__device__ __forceinline__ void p2l_terms(double2 q, int p, double x,
                                          double y, double s,
                                          double2* terms, int lane) {
  double2 z0 = as_complex(x, y);
  if (z0.x == 0.0 && z0.y == 0.0) z0 = make_double2(1.0, 0.0);
  double2 lz = log_c(make_double2(-z0.x, -z0.y));
  lz.x += log(s);
  terms[lane] = mul_c(q, lz);
  const double2 z0inv = inv_c(z0);
  const double2 mq = make_double2(-q.x, -q.y);
  double2 zp = make_double2(1.0, 0.0);
  for (int l = 1; l <= p; ++l) {
    zp = mul_c(zp, z0inv);
    const double2 t = mul_c(mq, zp);
    terms[l * kL2Threads + lane] = make_double2(t.x / l, t.y / l);
  }
}

// the same on pair lanes, 1/z0 = 0 at z0 = 0
template <typename T>
__device__ __forceinline__ void p2l_terms(T q, int p, T x, T y, T s,
                                          T* terms, int lane) {
  const int nc = p + 1;
  const T r2 = x * x + y * y;
  const bool zero = r2 == T(0);
  const T r2s = zero ? T(1) : r2;
  const T lgr = T(0.5) * log_t(r2s) + log_t(s);
  const T th = atan2_t(-y, zero ? T(1) : -x);
  terms[lane] = q * lgr;
  terms[nc * kL2Threads + lane] = q * th;
  const T ixr = x / r2s, ixi = -y / r2s;
  T pr = T(1), pi = T(0);
  for (int l = 1; l < nc; ++l) {
    const T nr = pr * ixr - pi * ixi;
    pi = pr * ixi + pi * ixr;
    pr = nr;
    terms[l * kL2Threads + lane] = -q * pr / T(l);
    terms[(nc + l) * kL2Threads + lane] = -q * pi / T(l);
  }
}

// K42: the tangents of the complex terms along (dx, dy), the offset's
// tangent d / s; z0 = 0 is the constant 1 there, so every tangent is 0
__device__ __forceinline__ void p2l_dipole_terms(double2 q, int p, double x,
                                                 double y, double dx,
                                                 double dy, double2* terms,
                                                 int lane) {
  using D = Dual<double>;
  Cx<D> z0{D(x, dx), D(__dadd_rn(y, 0.0), dy)};
  if (x == 0.0 && y == 0.0) z0 = Cx<D>{D(1.0, 0.0), D(0.0, 0.0)};
  // d log(-z0) = dz0 / z0; log s has no tangent
  const Cx<D> lz = log_c(Cx<D>{-z0.re, -z0.im});
  terms[lane] = mul_c(q, make_double2(lz.re.d, lz.im.d));
  const Cx<D> z0inv = inv(z0);
  const double2 mq = make_double2(-q.x, -q.y);
  Cx<D> zp{D(1.0, 0.0), D(0.0, 0.0)};
  for (int l = 1; l <= p; ++l) {
    zp = mul(zp, z0inv);
    const double2 t = mul_c(mq, make_double2(zp.re.d, zp.im.d));
    terms[l * kL2Threads + lane] = make_double2(t.x / l, t.y / l);
  }
}

// the same on pair lanes: at z0 = 0 only r^2 and atan2's x argument are
// constants, and the tangents of th and 1 / z0 stay, as in the JVP of
// laplace.py:356-366
template <typename T>
__device__ __forceinline__ void p2l_dipole_terms(T q, int p, T x, T y,
                                                 T dx, T dy, T* terms,
                                                 int lane) {
  using D = Dual<T>;
  const int nc = p + 1;
  const D one(T(1), T(0));
  const D xd(x, dx), yd(y, dy);
  const D r2 = xd * xd + yd * yd;
  const bool zero = r2.v == T(0);
  const D r2s = zero ? one : r2;
  const D lgr = D(T(0.5), T(0)) * log_t(r2s);
  const D th = atan2_t(-yd, zero ? one : -xd);
  terms[lane] = q * lgr.d;
  terms[nc * kL2Threads + lane] = q * th.d;
  const D ixr = xd / r2s, ixi = -yd / r2s;
  D pr = one, pi(T(0), T(0));
  for (int l = 1; l < nc; ++l) {
    const D nr = pr * ixr - pi * ixi;
    pi = pr * ixi + pi * ixr;
    pr = nr;
    terms[l * kL2Threads + lane] = -q * pr.d / T(l);
    terms[(nc + l) * kL2Threads + lane] = -q * pi.d / T(l);
  }
}

template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kL2Threads)
p2l_laplace2d_kernel(const T* __restrict__ sources, long long nsources,
                     const V* __restrict__ charges,
                     const T* __restrict__ dipoles,
                     const int* __restrict__ box_source_starts,
                     const int* __restrict__ box_source_counts,
                     const int* __restrict__ rows,
                     const int* __restrict__ starts,
                     const int* __restrict__ lists,
                     const T* __restrict__ centers, long long nboxes,
                     const T* __restrict__ box_scale, int p, int nc,
                     V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* terms = reinterpret_cast<V*>(smem_raw);                  // nc x warp
  V* acc = terms + nc * kL2Threads;                           // nc
  const int lane = threadIdx.x;
  const long long tbox = rows[blockIdx.x];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];
  for (int i = lane; i < nc; i += kL2Threads) acc[i] = vzero<V>();
  const T cx = centers[tbox], cy = centers[nboxes + tbox];
  const T s = box_scale[tbox];

  for (int e = e0; e < e1; ++e) {
    const int sbox = lists[e];
    const long long s0 = box_source_starts[sbox];
    const int ns = box_source_counts[sbox];
    for (int sb = 0; sb < ns; sb += kL2Threads) {
      const int j = sb + lane;
      if (j < ns) {
        const T x = (sources[s0 + j] - cx) / s;
        const T y = (sources[nsources + s0 + j] - cy) / s;
        if constexpr (kDipole) {
          p2l_dipole_terms(charges[s0 + j], p, x, y, dipoles[s0 + j] / s,
                           dipoles[nsources + s0 + j] / s, terms, lane);
        } else {
          p2l_terms(charges[s0 + j], p, x, y, s, terms, lane);
        }
      } else {
        for (int i = 0; i < nc; ++i)
          terms[i * kL2Threads + lane] = vzero<V>();
      }
      __syncwarp();
      // each lane sums the rows of the coefficients it owns
      for (int i = lane; i < nc; i += kL2Threads) {
        V t = vzero<V>();
        for (int jj = 0; jj < kL2Threads; ++jj)
          vadd(t, terms[i * kL2Threads + jj]);
        vadd(acc[i], t);
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < nc; i += kL2Threads)
    vadd(out[tbox * nc + i], acc[i]);
}

// }}}

// {{{ K38, K39

template <typename T>
__device__ __forceinline__ T part_of(T a, bool) {
  return a;
}
// a dual power's tangent (K39) or value
template <typename T>
__device__ __forceinline__ T part_of(Dual<T> a, bool tangent) {
  return tangent ? a.d : a.v;
}

// out[box] = [a_0 .. a_p] of the box's own sources: complex128
// interleaved (re, im), or [re | im] pair lanes; K39 the tangents along
// d / s (a_0's is 0)
template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kL2Threads)
p2m_laplace2d_kernel(const T* __restrict__ sources, long long nsources,
                     const V* __restrict__ charges,
                     const T* __restrict__ dipoles,
                     const int* __restrict__ box_source_starts,
                     const int* __restrict__ box_source_counts,
                     const int* __restrict__ rows,
                     const T* __restrict__ centers, long long nboxes,
                     const T* __restrict__ box_scale, int p,
                     T* __restrict__ out) {
  using S = typename std::conditional<kDipole, Dual<T>, T>::type;
  constexpr bool kCplx = std::is_same<V, double2>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);                    // 2 (p + 1)
  const int ncoeff = 2 * (p + 1);
  // where coefficient k's real and imaginary parts sit
  const int re_step = kCplx ? 2 : 1;
  const int im_off = kCplx ? 1 : p + 1;
  const int lane = threadIdx.x;
  const long long box = rows[blockIdx.x];
  const long long s0 = box_source_starts[box];
  const int ns = box_source_counts[box];
  for (int k = lane; k < ncoeff; k += kL2Threads) acc[k] = T(0);
  const T cx = centers[box], cy = centers[nboxes + box];
  const T s = box_scale[box];
  __syncwarp();

  for (int sb = 0; sb < ns; sb += kL2Threads) {
    const int j = sb + lane;
    // idle lanes: the origin, zero charge, zero tangent
    T x = T(0), y = T(0), dx = T(0), dy = T(0), qr = T(0), qi = T(0);
    if (j < ns) {
      x = (sources[s0 + j] - cx) / s;
      y = (sources[nsources + s0 + j] - cy) / s;
      if constexpr (kCplx) {
        qr = charges[s0 + j].x;
        qi = charges[s0 + j].y;
      } else {
        qr = charges[s0 + j];
      }
      if (kDipole) {
        dx = dipoles[s0 + j] / s;
        dy = dipoles[nsources + s0 + j] / s;
      }
    }
    if (!kDipole) {
      const T ar = warp_sum(qr);
      const T ai = kCplx ? warp_sum(qi) : T(0);
      if (lane == 0) {
        acc[0] += ar;
        acc[im_off] += ai;
      }
    }
    S zr, zi;
    if constexpr (kDipole) {
      zr = Dual<T>(x, dx);
      zi = Dual<T>(y, dy);
    } else {
      zr = x;
      zi = y;
    }
    S pr(1), pi(0);
    for (int k = 1; k <= p; ++k) {
      const S nr = pr * zr - pi * zi;
      pi = pr * zi + pi * zr;
      pr = nr;
      const T vr = part_of(pr, kDipole), vi = part_of(pi, kDipole);
      // -q zeta^k / k (its tangent for K39)
      T tr, ti;
      if constexpr (kCplx) {
        tr = (-qr * vr + qi * vi) / T(k);
        ti = (-qr * vi - qi * vr) / T(k);
      } else {
        tr = -qr * vr / T(k);
        ti = -qr * vi / T(k);
      }
      const T sr = warp_sum(tr), si = warp_sum(ti);
      if (lane == 0) {
        acc[re_step * k] += sr;
        acc[re_step * k + im_off] += si;
      }
    }
  }
  __syncwarp();
  for (int k = lane; k < ncoeff; k += kL2Threads)
    out[box * ncoeff + k] = acc[k];
}

// }}}

// {{{ K40

template <typename T, typename V>
__global__ void __launch_bounds__(kL2Threads)
l2p_laplace2d_kernel(const T* __restrict__ targets, long long ntargets,
                     const int* __restrict__ box_target_starts,
                     const int* __restrict__ box_target_counts,
                     const int* __restrict__ rows,
                     const T* __restrict__ locs,
                     const T* __restrict__ centers, long long nboxes,
                     const T* __restrict__ box_scale, int p,
                     V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);               // 2 (p + 1) + 3
  const int ncoeff = 2 * (p + 1);
  const long long box = rows[blockIdx.x];
  const long long t0 = box_target_starts[box];
  const int nt = box_target_counts[box];
  for (int k = threadIdx.x; k < ncoeff; k += kL2Threads)
    sl[k] = locs[box * ncoeff + k];
  if (threadIdx.x == 0) {
    sl[ncoeff] = centers[box];
    sl[ncoeff + 1] = centers[nboxes + box];
    sl[ncoeff + 2] = box_scale[box];
  }
  __syncthreads();
  const T s = sl[ncoeff + 2];

  for (int ti = threadIdx.x; ti < nt; ti += kL2Threads) {
    const T x = (targets[t0 + ti] - sl[ncoeff]) / s;
    const T y = (targets[ntargets + t0 + ti] - sl[ncoeff + 1]) / s;
    T pr = T(1), pi = T(0);
    if constexpr (std::is_same<V, double2>::value) {
      // sum_l L_l w^l
      T ar = sl[0], ai = sl[1];
      for (int l = 1; l <= p; ++l) {
        const T nr = pr * x - pi * y;
        pi = pr * y + pi * x;
        pr = nr;
        const T lr = sl[2 * l], li = sl[2 * l + 1];
        ar += lr * pr - li * pi;
        ai += lr * pi + li * pr;
      }
      out[t0 + ti] = make_double2(ar, ai);
    } else {
      // its real part on pair lanes
      const int nc = p + 1;
      T acc = sl[0];
      for (int l = 1; l < nc; ++l) {
        const T nr = pr * x - pi * y;
        pi = pr * y + pi * x;
        pr = nr;
        acc += sl[l] * pr - sl[nc + l] * pi;
      }
      out[t0 + ti] = acc;
    }
  }
}

// }}}

// coefficients a box holds: p + 1 complex, or 2 (p + 1) pair lanes
template <typename V>
int ncoeffs(long long p) {
  return 2 * (int)(p + 1);
}
template <>
int ncoeffs<double2>(long long p) {
  return (int)(p + 1);
}

template <typename T, typename V, bool kDipole>
int p2p(const void* targets, long long ntargets, const void* sources,
        long long nsources, const void* charges, const void* dipoles,
        const void* bts, const void* btc, const void* bss, const void* bsc,
        const void* target_boxes, long long nrows, const void* starts,
        const void* lists, void* out, void* stream) {
  if (nrows > 0) {
    p2p_laplace2d_kernel<T, V, kDipole>
        <<<(unsigned)nrows, kL2Threads, 0, (cudaStream_t)stream>>>(
            (const T*)targets, ntargets, (const T*)sources, nsources,
            (const V*)charges, (const T*)dipoles, (const int*)bts,
            (const int*)btc, (const int*)bss, (const int*)bsc,
            (const int*)target_boxes, (const int*)starts,
            (const int*)lists, (V*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename V>
int m2p(const void* targets, long long ntargets, const void* bts,
        const void* btc, const void* rows, long long nrows,
        const void* starts, const void* lists, const void* mpoles,
        const void* centers, long long nboxes, const void* box_scale,
        long long order, void* out, void* stream) {
  if (nrows > 0) {
    const int nc = ncoeffs<V>(order);
    const size_t smem = nc * sizeof(V);
    const cudaError_t err = allow_smem(m2p_laplace2d_kernel<T, V>, smem);
    if (err != cudaSuccess) return (int)err;
    m2p_laplace2d_kernel<T, V>
        <<<(unsigned)nrows, kL2Threads, smem, (cudaStream_t)stream>>>(
            (const T*)targets, ntargets, (const int*)bts, (const int*)btc,
            (const int*)rows, (const int*)starts, (const int*)lists,
            (const V*)mpoles, (const T*)centers, nboxes,
            (const T*)box_scale, (int)order, nc, (V*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename V, bool kDipole>
int p2l(const void* sources, long long nsources, const void* charges,
        const void* dipoles, const void* bss, const void* bsc,
        const void* rows, long long nrows, const void* starts,
        const void* lists, const void* centers, long long nboxes,
        const void* box_scale, long long order, void* out, void* stream) {
  if (nrows > 0) {
    const int nc = ncoeffs<V>(order);
    const size_t smem = (size_t)nc * (kL2Threads + 1) * sizeof(V);
    const cudaError_t err =
        allow_smem(p2l_laplace2d_kernel<T, V, kDipole>, smem);
    if (err != cudaSuccess) return (int)err;
    p2l_laplace2d_kernel<T, V, kDipole>
        <<<(unsigned)nrows, kL2Threads, smem, (cudaStream_t)stream>>>(
            (const T*)sources, nsources, (const V*)charges,
            (const T*)dipoles, (const int*)bss, (const int*)bsc,
            (const int*)rows, (const int*)starts, (const int*)lists,
            (const T*)centers, nboxes, (const T*)box_scale, (int)order, nc,
            (V*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename V, bool kDipole>
int p2m(const void* sources, long long nsources, const void* charges,
        const void* dipoles, const void* bss, const void* bsc,
        const void* rows, long long nrows, const void* centers,
        long long nboxes, const void* box_scale, long long order, void* out,
        void* stream) {
  if (nrows > 0) {
    const size_t smem = 2 * (order + 1) * sizeof(T);
    const cudaError_t err =
        allow_smem(p2m_laplace2d_kernel<T, V, kDipole>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_laplace2d_kernel<T, V, kDipole>
        <<<(unsigned)nrows, kL2Threads, smem, (cudaStream_t)stream>>>(
            (const T*)sources, nsources, (const V*)charges,
            (const T*)dipoles, (const int*)bss, (const int*)bsc,
            (const int*)rows, (const T*)centers, nboxes,
            (const T*)box_scale, (int)order, (T*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename V>
int l2p(const void* targets, long long ntargets, const void* bts,
        const void* btc, const void* rows, long long nrows, const void* locs,
        const void* centers, long long nboxes, const void* box_scale,
        long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = (2 * (order + 1) + 3) * sizeof(T);
    const cudaError_t err = allow_smem(l2p_laplace2d_kernel<T, V>, smem);
    if (err != cudaSuccess) return (int)err;
    l2p_laplace2d_kernel<T, V>
        <<<(unsigned)nrows, kL2Threads, smem, (cudaStream_t)stream>>>(
            (const T*)targets, ntargets, (const int*)bts, (const int*)btc,
            (const int*)rows, (const T*)locs, (const T*)centers, nboxes,
            (const T*)box_scale, (int)order, (V*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_LAPLACE2D_ENTRIES(suffix, T, V)                        \
  extern "C" int p2p_laplace2d_##suffix(                                    \
      const void* targets, long long ntargets, const void* sources,         \
      long long nsources, const void* charges, const void* bts,             \
      const void* btc, const void* bss, const void* bsc,                    \
      const void* target_boxes, long long nrows, const void* starts,        \
      const void* lists, void* out, void* stream) {                         \
    return boxtree_torch::p2p<T, V, false>(                                 \
        targets, ntargets, sources, nsources, charges, nullptr, bts, btc,   \
        bss, bsc, target_boxes, nrows, starts, lists, out, stream);         \
  }                                                                         \
  extern "C" int p2p_laplace2d_dipole_##suffix(                             \
      const void* targets, long long ntargets, const void* sources,         \
      long long nsources, const void* charges, const void* dipoles,         \
      const void* bts, const void* btc, const void* bss, const void* bsc,   \
      const void* target_boxes, long long nrows, const void* starts,        \
      const void* lists, void* out, void* stream) {                         \
    return boxtree_torch::p2p<T, V, true>(                                  \
        targets, ntargets, sources, nsources, charges, dipoles, bts, btc,   \
        bss, bsc, target_boxes, nrows, starts, lists, out, stream);         \
  }                                                                         \
  extern "C" int m2p_laplace2d_##suffix(                                    \
      const void* targets, long long ntargets, const void* bts,             \
      const void* btc, const void* rows, long long nrows,                   \
      const void* starts, const void* lists, const void* mpoles,            \
      const void* centers, long long nboxes, const void* box_scale,         \
      long long order, void* out, void* stream) {                           \
    return boxtree_torch::m2p<T, V>(targets, ntargets, bts, btc, rows,      \
                                    nrows, starts, lists, mpoles, centers,  \
                                    nboxes, box_scale, order, out, stream); \
  }                                                                         \
  extern "C" int p2l_laplace2d_##suffix(                                    \
      const void* sources, long long nsources, const void* charges,         \
      const void* bss, const void* bsc, const void* rows, long long nrows,  \
      const void* starts, const void* lists, const void* centers,           \
      long long nboxes, const void* box_scale, long long order, void* out,  \
      void* stream) {                                                       \
    return boxtree_torch::p2l<T, V, false>(                                 \
        sources, nsources, charges, nullptr, bss, bsc, rows, nrows, starts, \
        lists, centers, nboxes, box_scale, order, out, stream);             \
  }                                                                         \
  extern "C" int p2l_laplace2d_dipole_##suffix(                             \
      const void* sources, long long nsources, const void* charges,         \
      const void* dipoles, const void* bss, const void* bsc,                \
      const void* rows, long long nrows, const void* starts,                \
      const void* lists, const void* centers, long long nboxes,             \
      const void* box_scale, long long order, void* out, void* stream) {    \
    return boxtree_torch::p2l<T, V, true>(                                  \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, starts, \
        lists, centers, nboxes, box_scale, order, out, stream);             \
  }                                                                         \
  extern "C" int p2m_laplace2d_##suffix(                                    \
      const void* sources, long long nsources, const void* charges,         \
      const void* bss, const void* bsc, const void* rows, long long nrows,  \
      const void* centers, long long nboxes, const void* box_scale,         \
      long long order, void* out, void* stream) {                           \
    return boxtree_torch::p2m<T, V, false>(                                 \
        sources, nsources, charges, nullptr, bss, bsc, rows, nrows,         \
        centers, nboxes, box_scale, order, out, stream);                    \
  }                                                                         \
  extern "C" int p2m_laplace2d_dipole_##suffix(                             \
      const void* sources, long long nsources, const void* charges,         \
      const void* dipoles, const void* bss, const void* bsc,                \
      const void* rows, long long nrows, const void* centers,               \
      long long nboxes, const void* box_scale, long long order, void* out,  \
      void* stream) {                                                       \
    return boxtree_torch::p2m<T, V, true>(                                  \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows,         \
        centers, nboxes, box_scale, order, out, stream);                    \
  }                                                                         \
  extern "C" int l2p_laplace2d_##suffix(                                    \
      const void* targets, long long ntargets, const void* bts,             \
      const void* btc, const void* rows, long long nrows, const void* locs, \
      const void* centers, long long nboxes, const void* box_scale,         \
      long long order, void* out, void* stream) {                           \
    return boxtree_torch::l2p<T, V>(targets, ntargets, bts, btc, rows,      \
                                    nrows, locs, centers, nboxes,           \
                                    box_scale, order, out, stream);         \
  }

BOXTREE_TORCH_LAPLACE2D_ENTRIES(f32, float, float)
BOXTREE_TORCH_LAPLACE2D_ENTRIES(f64, double, double)
BOXTREE_TORCH_LAPLACE2D_ENTRIES(c128, double, double2)
