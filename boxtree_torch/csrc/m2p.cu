// K3 m2p_laplace3d: List-3 multipole evaluation,
// phi(t) += Re sum_{n,m} S_n^m((t - c_s) / r_s) M_n^m(s) / r_s
// over every List-3 source box s of t's box, skipping r = 0.
//
// Replaces boxtree_tpu/models/expansion_base.py:1440
// _eval_multipoles_rowmajor with boxtree_tpu/models/laplace.py:595
// _m2p_eval (irregular_pairs).  The per-source-level List-3 CSRs are merged
// into one CSR over target boxes at wrangler setup; rows name target boxes,
// entries source boxes.
//
// Bound: arithmetic.  Each (target, source box) pair evaluates the order-p
// recurrence (~(p+1)^2 complex steps, ~1,000 flops at p = 8) against one
// 2(p+1)^2-coefficient multipole that every thread of the CTA shares.  One
// CTA (one warp) per target box, one thread per target particle; each
// source box's multipole, centre and scale are staged in shared memory once
// per CTA, and the harmonics never leave registers (harmonics.cuh), so no
// (particles x coefficients) array is stored.
#include "harmonics.cuh"

namespace boxtree_torch {
namespace {

constexpr int kM2PThreads = 32;

template <typename T>
__global__ void __launch_bounds__(kM2PThreads)
m2p_kernel(const T* __restrict__ targets, long long ntargets,
           const int* __restrict__ box_target_starts,
           const int* __restrict__ box_target_counts,
           const int* __restrict__ rows, const int* __restrict__ starts,
           const int* __restrict__ lists, const T* __restrict__ mpoles,
           const T* __restrict__ centers, long long nboxes,
           const T* __restrict__ box_scale, int p, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smp = reinterpret_cast<T*>(smem_raw);
  const int nc = (p + 1) * (p + 1);  // complex coefficients
  const int ncoeff = 2 * nc;         // [re | im]
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
    T acc = T(0);
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
      T val = T(0);
      irregular_pairs_foreach(x, y, z, p, [&](int n, int m, T sr, T si) {
        const int i = n * n + n + m;
        if (m == 0) {
          val += sr * smp[i] - si * smp[nc + i];
        } else {
          // S_n^{-m} = (-1)^m conj(S_n^m)
          const int j = n * n + n - m;
          const T sg = (m & 1) ? T(-1) : T(1);
          val += sr * (smp[i] + sg * smp[j])
                 - si * (smp[nc + i] - sg * smp[nc + j]);
        }
      });
      acc += val / s;
    }
    if (active) out[t0 + ti] = acc;
  }
}

template <typename T>
int m2p(const void* targets, long long ntargets, const void* bts,
        const void* btc, const void* rows, long long nrows,
        const void* starts, const void* lists, const void* mpoles,
        const void* centers, long long nboxes, const void* box_scale,
        long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = (2 * (order + 1) * (order + 1) + 4) * sizeof(T);
    m2p_kernel<T><<<(unsigned)nrows, kM2PThreads, smem,
                    (cudaStream_t)stream>>>(
        (const T*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, (const int*)starts, (const int*)lists,
        (const T*)mpoles, (const T*)centers, nboxes, (const T*)box_scale,
        (int)order, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_M2P_ENTRY(suffix, T)                                  \
  extern "C" int m2p_laplace3d_##suffix(                                   \
      const void* targets, long long ntargets, const void* bts,            \
      const void* btc, const void* rows, long long nrows,                  \
      const void* starts, const void* lists, const void* mpoles,           \
      const void* centers, long long nboxes, const void* box_scale,        \
      long long order, void* out, void* stream) {                          \
    return boxtree_torch::m2p<T>(targets, ntargets, bts, btc, rows, nrows, \
                                 starts, lists, mpoles, centers, nboxes,   \
                                 box_scale, order, out, stream);           \
  }

BOXTREE_TORCH_M2P_ENTRY(f32, float)
BOXTREE_TORCH_M2P_ENTRY(f64, double)
