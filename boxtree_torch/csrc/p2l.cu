// K4 p2l_laplace3d: List-4 local-expansion formation,
// L(b) += sum_s q_s S((x_s - c_b) / r_b) / r_b
// over the source particles of every List-4 box of target-or-target-parent
// box b, skipping r = 0, added into the box's local coefficients (the
// caller passes the M2L output, or zeros).
// K23 p2l_laplace3d_dipole: the same for dipole sources, the JVP of each
// term in the source offset along d_s / r_b,
// L(b) += sum_s q_s (dS((x_s - c_b) / r_b)[d_s / r_b]) / r_b, 0 at r = 0.
//
// K4 replaces boxtree_tpu/models/expansion_base.py:1629
// _form_locals_rowmajor (edges form :1733) with boxtree_tpu/models/
// laplace.py:486 _p2l_terms (pairs :604; the scale handling of
// expansion_base.py:1680-1684); K23 the reference's JVP of it
// (expansion_base.py:1688-1694, :1756-1764).
//
// Entry points: _f32 / _f64 (2 (p+1)^2 [re | im] pair coefficients, real
// charges, the pairs wrangler) and _c128 ((p+1)^2 complex128 coefficients,
// interleaved re, im, complex charges, the complex wrangler), for both.
//
// K23 is K4's loop on dual numbers (laplace3d.cuh): the recurrence of
// harmonics.cuh runs on Dual<T> offsets whose tangents are d_s / r_b, and
// each coefficient's tangent is what K4 would sum.  The recurrence costs
// about three times K4's, with 10-25 % more registers and no extra memory
// traffic but the dipoles.
//
// Bound: arithmetic plus the reduction.  Each source particle evaluates the
// order-p recurrence once and contributes to all coefficients of one box.
// One CTA (one warp) per box with List-4 entries, one thread per source
// particle; each coefficient is summed across the warp with shuffles as the
// recurrence produces it (two sums, four for complex charges), and lane 0
// adds it to the box's accumulator in shared memory: no atomics, no
// (particles x coefficients) array.  Shared memory: the accumulator, 2
// (p+1)^2 values of T, 2,704 B at order 12 in float64 or complex128, 48 KiB
// at order 54; the launcher opts in past 48 KiB.  ptxas (sm_90a): K4 48 /
// 60 / 64 registers (f32 / f64 / c128), K23 57 / 70 / 80, no spills.
#include "harmonics.cuh"
#include "laplace3d.cuh"

namespace boxtree_torch {
namespace {

constexpr int kP2LThreads = 32;

template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kP2LThreads)
p2l_kernel(const T* __restrict__ sources, long long nsources,
           const V* __restrict__ charges, const T* __restrict__ dipoles,
           const int* __restrict__ box_source_starts,
           const int* __restrict__ box_source_counts,
           const int* __restrict__ rows, const int* __restrict__ starts,
           const int* __restrict__ lists, const T* __restrict__ centers,
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
  const long long tbox = rows[blockIdx.x];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];
  for (int k = lane; k < ncoeff; k += kP2LThreads) acc[k] = T(0);
  const T cx = centers[tbox], cy = centers[nboxes + tbox],
          cz = centers[2 * nboxes + tbox];
  const T s = box_scale[tbox];
  __syncwarp();

  for (int e = e0; e < e1; ++e) {
    const int sbox = lists[e];
    const long long s0 = box_source_starts[sbox];
    const int ns = box_source_counts[sbox];
    for (int sb = 0; sb < ns; sb += kP2LThreads) {
      const int j = sb + lane;
      // r = 0 and idle lanes evaluate at (1, 1, 1) with zero weight and
      // zero tangent
      T x = T(1), y = T(1), z = T(1), dx = T(0), dy = T(0), dz = T(0);
      T qr = T(0), qi = T(0);
      if (j < ns) {
        const T xj = (sources[s0 + j] - cx) / s;
        const T yj = (sources[nsources + s0 + j] - cy) / s;
        const T zj = (sources[2 * nsources + s0 + j] - cz) / s;
        if (xj * xj + yj * yj + zj * zj > T(0)) {
          x = xj;
          y = yj;
          z = zj;
          if constexpr (kIsComplex<V>) {
            qr = charges[s0 + j].x / s;
            qi = charges[s0 + j].y / s;
          } else {
            qr = charges[s0 + j] / s;
          }
          if (kDipole) {
            dx = dipoles[s0 + j] / s;
            dy = dipoles[nsources + s0 + j] / s;
            dz = dipoles[2 * nsources + s0 + j] / s;
          }
        }
      }
      // coefficient (n, m) of this lane's source, S = sr + i si, times q,
      // summed over the warp; S_n^{-m} = (-1)^m conj(S_n^m)
      auto add = [&](int n, int m, T sr, T si) {
        const int i = re_step * (n * n + n + m);
        const int jj = re_step * (n * n + n - m);
        const T sg = (m & 1) ? T(-1) : T(1);
        if constexpr (kIsComplex<V>) {
          const T ar = warp_sum(sr * qr - si * qi);
          const T ai = warp_sum(sr * qi + si * qr);
          T br = T(0), bi = T(0);
          if (m > 0) {
            br = warp_sum(sr * qr + si * qi);
            bi = warp_sum(sr * qi - si * qr);
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
          const T vr = warp_sum(sr * qr);
          const T vi = warp_sum(si * qr);
          if (lane == 0) {
            acc[i] += vr;
            acc[i + im_off] += vi;
            if (m > 0) {
              acc[jj] += sg * vr;
              acc[jj + im_off] -= sg * vi;
            }
          }
        }
      };
      if constexpr (kDipole) {
        irregular_pairs_foreach(
            Dual<T>(x, dx), Dual<T>(y, dy), Dual<T>(z, dz), p,
            [&](int n, int m, Dual<T> sr, Dual<T> si) {
              add(n, m, sr.d, si.d);
            });
      } else {
        irregular_pairs_foreach(x, y, z, p, add);
      }
    }
  }
  __syncwarp();
  for (int k = lane; k < ncoeff; k += kP2LThreads)
    out[tbox * ncoeff + k] += acc[k];
}

template <typename T, typename V, bool kDipole>
int p2l(const void* sources, long long nsources, const void* charges,
        const void* dipoles, const void* bss, const void* bsc,
        const void* rows, long long nrows, const void* starts,
        const void* lists, const void* centers, long long nboxes,
        const void* box_scale, long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = 2 * (order + 1) * (order + 1) * sizeof(T);
    const cudaError_t err = allow_smem(p2l_kernel<T, V, kDipole>, smem);
    if (err != cudaSuccess) return (int)err;
    p2l_kernel<T, V, kDipole><<<(unsigned)nrows, kP2LThreads, smem,
                                (cudaStream_t)stream>>>(
        (const T*)sources, nsources, (const V*)charges, (const T*)dipoles,
        (const int*)bss, (const int*)bsc, (const int*)rows,
        (const int*)starts, (const int*)lists, (const T*)centers, nboxes,
        (const T*)box_scale, (int)order, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_P2L_ENTRY(suffix, T, V)                                \
  extern "C" int p2l_laplace3d_##suffix(                                    \
      const void* sources, long long nsources, const void* charges,         \
      const void* bss, const void* bsc, const void* rows, long long nrows,  \
      const void* starts, const void* lists, const void* centers,           \
      long long nboxes, const void* box_scale, long long order, void* out,  \
      void* stream) {                                                       \
    return boxtree_torch::p2l<T, V, false>(                                 \
        sources, nsources, charges, nullptr, bss, bsc, rows, nrows, starts, \
        lists, centers, nboxes, box_scale, order, out, stream);             \
  }                                                                         \
  extern "C" int p2l_laplace3d_dipole_##suffix(                             \
      const void* sources, long long nsources, const void* charges,         \
      const void* dipoles, const void* bss, const void* bsc,                \
      const void* rows, long long nrows, const void* starts,                \
      const void* lists, const void* centers, long long nboxes,             \
      const void* box_scale, long long order, void* out, void* stream) {    \
    return boxtree_torch::p2l<T, V, true>(                                  \
        sources, nsources, charges, dipoles, bss, bsc, rows, nrows, starts, \
        lists, centers, nboxes, box_scale, order, out, stream);             \
  }

BOXTREE_TORCH_P2L_ENTRY(f32, float, float)
BOXTREE_TORCH_P2L_ENTRY(f64, double, double)
BOXTREE_TORCH_P2L_ENTRY(c128, double, double2)
