// K28 p2m_laplace3d: 3D Laplace multipole formation,
// M(b) = sum_s conj(R((x_s - c_b) / r_b)) q_s
// over the source particles that box b owns itself (its nonchild range,
// on any level: the extent tree keeps sources on coarser boxes), written
// once into the box's row; the caller zeroes the rows of boxes without
// sources and applies level_to_order's mask after.
// K29 p2m_laplace3d_dipole: the same for dipole sources, the JVP of each
// term in the source offset along d_s / r_b,
// M(b) = sum_s conj(dR((x_s - c_b) / r_b)[d_s / r_b]) q_s.
//
// K28 replaces boxtree_tpu/models/expansion_base.py:651 form_multipoles
// with boxtree_tpu/models/laplace.py:473 _p2m_terms (pairs :581); K29 the
// reference's JVP of it (expansion_base.py:664-673).
//
// Entry points: _f32 / _f64 (2 (p+1)^2 [re | im] pair coefficients, the
// conj(R) q layout [Rr | -Ri] q, real charges, the pairs wrangler) and
// _c128 ((p+1)^2 complex128 coefficients, interleaved re, im, complex
// charges, the complex wrangler), for both.
//
// No r = 0 guard: R is a polynomial in the offset, so a source at its
// box's centre adds q to R_0^0 (and a dipole there to the n = 1 terms),
// as in the reference.  Idle lanes evaluate at the origin with zero
// charge and zero tangent.
//
// Bound: bytes.  Each source is read once (3 coordinates, its charge, 3
// dipole components) and each box's row written once, ~0.04 ms at the
// main path's 1e6 points in float32; the order-p recurrence (~(p+1)^2
// complex steps a source, three times that on dual numbers for K29) and
// the warp sums are what the kernel spends its time on.  One CTA (one
// warp) per box with sources, one lane per source in strides of 32; each
// coefficient is summed across the warp with shuffles as the recurrence
// produces it (two sums, four for complex charges), and lane 0 adds it to
// the box's accumulator in shared memory, 2 (p+1)^2 values of T (2,704 B
// at order 12 in float64 or complex128; the launcher opts in past 48
// KiB).  One CTA owns each row, so there are no atomics and the result
// does not depend on the order in which CTAs run.
#include "harmonics.cuh"
#include "laplace3d.cuh"

namespace boxtree_torch {
namespace {

constexpr int kP2MThreads = 32;

template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kP2MThreads)
p2m_kernel(const T* __restrict__ sources, long long nsources,
           const V* __restrict__ charges, const T* __restrict__ dipoles,
           const int* __restrict__ box_source_starts,
           const int* __restrict__ box_source_counts,
           const int* __restrict__ rows, const T* __restrict__ centers,
           long long nboxes, const T* __restrict__ box_scale, int p,
           T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int nc = (p + 1) * (p + 1);
  const int ncoeff = 2 * nc;
  // where coefficient i's real and imaginary parts sit
  const int re_step = kIsComplex<V> ? 2 : 1;
  const int im_off = kIsComplex<V> ? 1 : nc;
  const int lane = threadIdx.x;
  const long long box = rows[blockIdx.x];
  const long long s0 = box_source_starts[box];
  const int ns = box_source_counts[box];
  for (int k = lane; k < ncoeff; k += kP2MThreads) acc[k] = T(0);
  const T cx = centers[box], cy = centers[nboxes + box],
          cz = centers[2 * nboxes + box];
  const T s = box_scale[box];
  __syncwarp();

  for (int sb = 0; sb < ns; sb += kP2MThreads) {
    const int j = sb + lane;
    T x = T(0), y = T(0), z = T(0), dx = T(0), dy = T(0), dz = T(0);
    T qr = T(0), qi = T(0);
    if (j < ns) {
      x = (sources[s0 + j] - cx) / s;
      y = (sources[nsources + s0 + j] - cy) / s;
      z = (sources[2 * nsources + s0 + j] - cz) / s;
      if constexpr (kIsComplex<V>) {
        qr = charges[s0 + j].x;
        qi = charges[s0 + j].y;
      } else {
        qr = charges[s0 + j];
      }
      if (kDipole) {
        dx = dipoles[s0 + j] / s;
        dy = dipoles[nsources + s0 + j] / s;
        dz = dipoles[2 * nsources + s0 + j] / s;
      }
    }
    // coefficient (n, m) of this lane's source, R = rr + i ri: conj(R) q
    // at (n, m) and, by R_n^{-m} = (-1)^m conj(R_n^m), (-1)^m R q at
    // (n, -m), summed over the warp
    auto add = [&](int n, int m, T rr, T ri) {
      const int i = re_step * (n * n + n + m);
      const int jj = re_step * (n * n + n - m);
      const T sg = (m & 1) ? T(-1) : T(1);
      if constexpr (kIsComplex<V>) {
        const T ar = warp_sum(rr * qr + ri * qi);
        const T ai = warp_sum(rr * qi - ri * qr);
        T br = T(0), bi = T(0);
        if (m > 0) {
          br = warp_sum(rr * qr - ri * qi);
          bi = warp_sum(rr * qi + ri * qr);
        }
        if (lane == 0) {
          acc[i] += ar;
          acc[i + im_off] += ai;
          if (m > 0) {
            acc[jj] += sg * br;
            acc[jj + im_off] += sg * bi;
          }
        }
      } else {
        // [Rr | -Ri] q; at (n, -m) Rr = sg rr and -Ri = sg ri
        const T vr = warp_sum(rr * qr);
        const T vi = warp_sum(ri * qr);
        if (lane == 0) {
          acc[i] += vr;
          acc[i + im_off] -= vi;
          if (m > 0) {
            acc[jj] += sg * vr;
            acc[jj + im_off] += sg * vi;
          }
        }
      }
    };
    if constexpr (kDipole) {
      regular_pairs_foreach(
          Dual<T>(x, dx), Dual<T>(y, dy), Dual<T>(z, dz), p,
          [&](int n, int m, Dual<T> rr, Dual<T> ri) {
            add(n, m, rr.d, ri.d);
          });
    } else {
      regular_pairs_foreach(x, y, z, p, add);
    }
  }
  __syncwarp();
  for (int k = lane; k < ncoeff; k += kP2MThreads)
    out[box * ncoeff + k] = acc[k];
}

template <typename T, typename V, bool kDipole>
int p2m(const void* sources, long long nsources, const void* charges,
        const void* dipoles, const void* bss, const void* bsc,
        const void* rows, long long nrows, const void* centers,
        long long nboxes, const void* box_scale, long long order, void* out,
        void* stream) {
  if (nrows > 0) {
    const size_t smem = 2 * (order + 1) * (order + 1) * sizeof(T);
    const cudaError_t err = allow_smem(p2m_kernel<T, V, kDipole>, smem);
    if (err != cudaSuccess) return (int)err;
    p2m_kernel<T, V, kDipole><<<(unsigned)nrows, kP2MThreads, smem,
                                (cudaStream_t)stream>>>(
        (const T*)sources, nsources, (const V*)charges, (const T*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows,
        (const T*)centers, nboxes, (const T*)box_scale, (int)order,
        (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_P2M_ENTRY(suffix, T, V)                                \
  extern "C" int p2m_laplace3d_##suffix(                                    \
      const void* sources, long long nsources, const void* charges,         \
      const void* bss, const void* bsc, const void* rows, long long nrows,  \
      const void* centers, long long nboxes, const void* box_scale,         \
      long long order, void* out, void* stream) {                           \
    return boxtree_torch::p2m<T, V, false>(                                 \
        sources, nsources, charges, nullptr, bss, bsc, rows, nrows,         \
        centers, nboxes, box_scale, order, out, stream);                    \
  }                                                                         \
  extern "C" int p2m_laplace3d_dipole_##suffix(                             \
      const void* sources, long long nsources, const void* charges,         \
      const void* dipoles, const void* bss, const void* bsc,                \
      const void* rows, long long nrows, const void* centers,               \
      long long nboxes, const void* box_scale, long long order, void* out,  \
      void* stream) {                                                       \
    return boxtree_torch::p2m<T, V, true>(                                  \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows,         \
        centers, nboxes, box_scale, order, out, stream);                    \
  }

BOXTREE_TORCH_P2M_ENTRY(f32, float, float)
BOXTREE_TORCH_P2M_ENTRY(f64, double, double)
BOXTREE_TORCH_P2M_ENTRY(c128, double, double2)
