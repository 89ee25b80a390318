// K4 p2l_laplace3d: List-4 local-expansion formation,
// L(b) += sum_s q_s S((x_s - c_b) / r_b) / r_b
// over the source particles of every List-4 box of target-or-target-parent
// box b, skipping r = 0, added into the box's 2(p+1)^2 local coefficients
// (the caller passes the M2L output, or zeros).
//
// Replaces boxtree_tpu/models/expansion_base.py:1629 _form_locals_rowmajor
// with boxtree_tpu/models/laplace.py:604 _p2l_terms (and the scale handling
// of expansion_base.py:1680-1684).
//
// Bound: arithmetic plus the reduction.  Each source particle evaluates the
// order-p recurrence once and contributes to all 2(p+1)^2 coefficients of
// one box.  One CTA (one warp) per box with List-4 entries, one thread per
// source particle; each coefficient is summed across the warp with
// shuffles as the recurrence produces it (harmonics.cuh), and lane 0 adds
// it to the box's accumulator in shared memory: no atomics, no
// (particles x coefficients) array.
#include "harmonics.cuh"

namespace boxtree_torch {
namespace {

constexpr int kP2LThreads = 32;

template <typename T>
__global__ void __launch_bounds__(kP2LThreads)
p2l_kernel(const T* __restrict__ sources, long long nsources,
           const T* __restrict__ charges,
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
      T x = T(1), y = T(1), z = T(1), qs = T(0);
      if (j < ns) {
        const T xj = (sources[s0 + j] - cx) / s;
        const T yj = (sources[nsources + s0 + j] - cy) / s;
        const T zj = (sources[2 * nsources + s0 + j] - cz) / s;
        if (xj * xj + yj * yj + zj * zj > T(0)) {
          // r = 0 and idle lanes evaluate at (1, 1, 1) with zero weight
          x = xj;
          y = yj;
          z = zj;
          qs = charges[s0 + j] / s;
        }
      }
      irregular_pairs_foreach(x, y, z, p, [&](int n, int m, T sr, T si) {
        const T vr = warp_sum(sr * qs);
        const T vi = warp_sum(si * qs);
        if (lane == 0) {
          const int i = n * n + n + m;
          acc[i] += vr;
          acc[nc + i] += vi;
          if (m > 0) {
            // S_n^{-m} = (-1)^m conj(S_n^m)
            const int jj = n * n + n - m;
            const T sg = (m & 1) ? T(-1) : T(1);
            acc[jj] += sg * vr;
            acc[nc + jj] -= sg * vi;
          }
        }
      });
    }
  }
  __syncwarp();
  for (int k = lane; k < ncoeff; k += kP2LThreads)
    out[tbox * ncoeff + k] += acc[k];
}

template <typename T>
int p2l(const void* sources, long long nsources, const void* charges,
        const void* bss, const void* bsc, const void* rows, long long nrows,
        const void* starts, const void* lists, const void* centers,
        long long nboxes, const void* box_scale, long long order, void* out,
        void* stream) {
  if (nrows > 0) {
    const size_t smem = 2 * (order + 1) * (order + 1) * sizeof(T);
    p2l_kernel<T><<<(unsigned)nrows, kP2LThreads, smem,
                    (cudaStream_t)stream>>>(
        (const T*)sources, nsources, (const T*)charges, (const int*)bss,
        (const int*)bsc, (const int*)rows, (const int*)starts,
        (const int*)lists, (const T*)centers, nboxes, (const T*)box_scale,
        (int)order, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_P2L_ENTRY(suffix, T)                                 \
  extern "C" int p2l_laplace3d_##suffix(                                  \
      const void* sources, long long nsources, const void* charges,       \
      const void* bss, const void* bsc, const void* rows,                 \
      long long nrows, const void* starts, const void* lists,             \
      const void* centers, long long nboxes, const void* box_scale,       \
      long long order, void* out, void* stream) {                         \
    return boxtree_torch::p2l<T>(sources, nsources, charges, bss, bsc,    \
                                 rows, nrows, starts, lists, centers,     \
                                 nboxes, box_scale, order, out, stream);  \
  }

BOXTREE_TORCH_P2L_ENTRY(f32, float)
BOXTREE_TORCH_P2L_ENTRY(f64, double)
