// K3 m2p_laplace3d: List-3 multipole evaluation,
// phi(t) += sum_{n,m} S_n^m((t - c_s) / r_s) M_n^m(s) / r_s
// over every List-3 source box s of t's box, skipping r = 0: complex for
// the _c128 entry point ((p+1)^2 complex128 coefficients, interleaved re,
// im, over float64 geometry), its real part for _f32 / _f64 ([re | im]
// pairs of the geometry's type).
//
// Replaces boxtree_tpu/models/expansion_base.py:1440
// _eval_multipoles_rowmajor (edges form :1546) with boxtree_tpu/models/
// laplace.py:481 _m2p_eval (pairs :595, irregular_pairs).  The
// per-source-level List-3 CSRs are merged into one CSR over target boxes
// at wrangler setup; rows name target boxes, entries source boxes.
//
// Bound: arithmetic.  Each (target, source box) pair evaluates the order-p
// recurrence (~(p+1)^2 complex steps, ~1,000 flops at p = 8) against one
// 2(p+1)^2-value multipole that every thread of the CTA shares.  One
// CTA (one warp) per target box, one thread per target particle; each
// source box's multipole, centre and scale are staged in shared memory once
// per CTA, and the harmonics never leave registers (harmonics.cuh), so no
// (particles x coefficients) array is stored.
#include "harmonics.cuh"
#include "laplace3d.cuh"

namespace boxtree_torch {
namespace {

constexpr int kM2PThreads = 32;

template <typename T, typename V>
__global__ void __launch_bounds__(kM2PThreads)
m2p_kernel(const T* __restrict__ targets, long long ntargets,
           const int* __restrict__ box_target_starts,
           const int* __restrict__ box_target_counts,
           const int* __restrict__ rows, const int* __restrict__ starts,
           const int* __restrict__ lists, const T* __restrict__ mpoles,
           const T* __restrict__ centers, long long nboxes,
           const T* __restrict__ box_scale, int p, V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smp = reinterpret_cast<T*>(smem_raw);
  const int nc = (p + 1) * (p + 1);  // complex coefficients
  const int ncoeff = 2 * nc;         // values of T: [re | im] or (re, im)
  // where coefficient i's real and imaginary parts sit
  const int re_step = kIsComplex<V> ? 2 : 1;
  const int im_off = kIsComplex<V> ? 1 : nc;
  const int tbox = rows[blockIdx.x];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[blockIdx.x], e1 = starts[blockIdx.x + 1];

  for (int tb = 0; tb < nt; tb += kM2PThreads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    T tx = T(0), ty = T(0), tz = T(0);
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
      tz = targets[2 * ntargets + t0 + ti];
    }
    T acc_re = T(0), acc_im = T(0);
    for (int e = e0; e < e1; ++e) {
      const long long sbox = lists[e];
      __syncthreads();
      for (int k = threadIdx.x; k < ncoeff; k += kM2PThreads)
        smp[k] = mpoles[sbox * ncoeff + k];
      if (threadIdx.x == 0) {
        smp[ncoeff] = centers[sbox];
        smp[ncoeff + 1] = centers[nboxes + sbox];
        smp[ncoeff + 2] = centers[2 * nboxes + sbox];
        smp[ncoeff + 3] = box_scale[sbox];
      }
      __syncthreads();
      if (!active) continue;
      const T s = smp[ncoeff + 3];
      const T x = (tx - smp[ncoeff]) / s;
      const T y = (ty - smp[ncoeff + 1]) / s;
      const T z = (tz - smp[ncoeff + 2]) / s;
      if (!(x * x + y * y + z * z > T(0))) continue;
      T val_re = T(0), val_im = T(0);
      irregular_pairs_foreach(x, y, z, p, [&](int n, int m, T sr, T si) {
        const int i = re_step * (n * n + n + m);
        const T mr = smp[i], mi = smp[i + im_off];
        if (m == 0) {
          val_re += sr * mr - si * mi;
          if (kIsComplex<V>) val_im += sr * mi + si * mr;
        } else {
          // S_n^{-m} = (-1)^m conj(S_n^m)
          const int j = re_step * (n * n + n - m);
          const T sg = (m & 1) ? T(-1) : T(1);
          const T nr = smp[j], ni = smp[j + im_off];
          val_re += sr * (mr + sg * nr) - si * (mi - sg * ni);
          if (kIsComplex<V>)
            val_im += sr * (mi + sg * ni) + si * (mr - sg * nr);
        }
      });
      acc_re += val_re / s;
      acc_im += val_im / s;
    }
    if (active) {
      if constexpr (kIsComplex<V>)
        out[t0 + ti] = make_double2(acc_re, acc_im);
      else
        out[t0 + ti] = acc_re;
    }
  }
}

template <typename T, typename V>
int m2p(const void* targets, long long ntargets, const void* bts,
        const void* btc, const void* rows, long long nrows,
        const void* starts, const void* lists, const void* mpoles,
        const void* centers, long long nboxes, const void* box_scale,
        long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = (2 * (order + 1) * (order + 1) + 4) * sizeof(T);
    const cudaError_t err = allow_smem(m2p_kernel<T, V>, smem);
    if (err != cudaSuccess) return (int)err;
    m2p_kernel<T, V><<<(unsigned)nrows, kM2PThreads, smem,
                       (cudaStream_t)stream>>>(
        (const T*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, (const int*)starts, (const int*)lists,
        (const T*)mpoles, (const T*)centers, nboxes, (const T*)box_scale,
        (int)order, (V*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_M2P_ENTRY(suffix, T, V)                               \
  extern "C" int m2p_laplace3d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,            \
      const void* btc, const void* rows, long long nrows,                  \
      const void* starts, const void* lists, const void* mpoles,           \
      const void* centers, long long nboxes, const void* box_scale,        \
      long long order, void* out, void* stream) {                          \
    return boxtree_torch::m2p<T, V>(targets, ntargets, bts, btc, rows,     \
                                    nrows, starts, lists, mpoles, centers, \
                                    nboxes, box_scale, order, out, stream);\
  }

BOXTREE_TORCH_M2P_ENTRY(f32, float, float)
BOXTREE_TORCH_M2P_ENTRY(f64, double, double)
BOXTREE_TORCH_M2P_ENTRY(c128, double, double2)
