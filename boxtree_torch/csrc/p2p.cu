// K2 p2p_laplace3d: List-1 direct evaluation, phi(t) = sum q_s / |t - s|
// over the source particles of every List-1 box of t's box, skipping r = 0.
// K22 p2p_laplace3d_dipole: the same for dipole sources, the derivative
// along the dipole d_s of each term in its source position,
// phi(t) = sum q_s d_s . (t - s) / |t - s|^3, 0 at r = 0.
//
// K2 replaces boxtree_tpu/models/expansion_base.py:1258
// _eval_direct_rowmajor (edges form :1341) with boxtree_tpu/models/
// laplace.py:492 _p2p; K22 the JVP the reference takes of it in the source
// positions (expansion_base.py:1314-1324, :1350-1360).  Unlike the
// reference it builds no padded particle blocks and no bucketed row maps
// (expansion_base.py:1215-1244): a box's nonchild particles are the
// contiguous tree-order range [box_*_starts, + box_*_counts_nonchild).  Both
// run on List 1 and on the close lists of a tree with target extents.
//
// Entry points: _f32 / _f64 (real charges and potentials, the pairs
// wrangler) and _c128 (complex charges and potentials over float64
// geometry, the complex wrangler), for both kernels.
//
// Bound: arithmetic.  Each pair costs ~10 flops (K22 ~17, complex charges 2
// more) plus one rsqrt on the SFU and reads 16-40 bytes from shared memory,
// while each source particle is read from device memory once per target box
// that lists it (~22 boxes of <= 30 particles per row at 1e6 points): pairs
// outnumber global loads 30 to 1.  One CTA (one warp) per target box, one
// thread per target particle; the source boxes stream through shared memory
// in warp-sized tiles, and every thread keeps its sum in a register and
// writes its potential once.  ptxas (sm_90a): K2 53 / 39 / 41 registers
// (f32 / f64 / c128), K22 48 / 52 / 54 with 896 / 1,792 / 2,048 B of
// static shared memory, no spills.
#include "laplace3d.cuh"

namespace boxtree_torch {
namespace {

constexpr int kP2PThreads = 32;

template <typename T, typename V, bool kDipole>
__global__ void __launch_bounds__(kP2PThreads)
p2p_kernel(const T* __restrict__ targets, long long ntargets,
           const T* __restrict__ sources, long long nsources,
           const V* __restrict__ charges, const T* __restrict__ dipoles,
           const int* __restrict__ box_target_starts,
           const int* __restrict__ box_target_counts,
           const int* __restrict__ box_source_starts,
           const int* __restrict__ box_source_counts,
           const int* __restrict__ target_boxes,
           const int* __restrict__ starts, const int* __restrict__ lists,
           V* __restrict__ out) {
  __shared__ T sx[kP2PThreads], sy[kP2PThreads], sz[kP2PThreads];
  __shared__ T sdx[kDipole ? kP2PThreads : 1], sdy[kDipole ? kP2PThreads : 1],
      sdz[kDipole ? kP2PThreads : 1];
  __shared__ V sq[kP2PThreads];
  const int row = blockIdx.x;
  const int tbox = target_boxes[row];
  const long long t0 = box_target_starts[tbox];
  const int nt = box_target_counts[tbox];
  const int e0 = starts[row], e1 = starts[row + 1];

  for (int tb = 0; tb < nt; tb += kP2PThreads) {
    const int ti = tb + threadIdx.x;
    const bool active = ti < nt;
    T tx = T(0), ty = T(0), tz = T(0);
    if (active) {
      tx = targets[t0 + ti];
      ty = targets[ntargets + t0 + ti];
      tz = targets[2 * ntargets + t0 + ti];
    }
    V acc = val_zero<V>();
    for (int e = e0; e < e1; ++e) {
      const int sbox = lists[e];
      const long long s0 = box_source_starts[sbox];
      const int ns = box_source_counts[sbox];
      for (int sb = 0; sb < ns; sb += kP2PThreads) {
        const int cnt = min(kP2PThreads, ns - sb);
        __syncthreads();
        if (threadIdx.x < cnt) {
          const long long s = s0 + sb + threadIdx.x;
          sx[threadIdx.x] = sources[s];
          sy[threadIdx.x] = sources[nsources + s];
          sz[threadIdx.x] = sources[2 * nsources + s];
          sq[threadIdx.x] = charges[s];
          if (kDipole) {
            sdx[threadIdx.x] = dipoles[s];
            sdy[threadIdx.x] = dipoles[nsources + s];
            sdz[threadIdx.x] = dipoles[2 * nsources + s];
          }
        }
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const T dx = tx - sx[j], dy = ty - sy[j], dz = tz - sz[j];
          const T r2 = dx * dx + dy * dy + dz * dz;
          if (r2 > T(0)) {
            T g = rsqrt_t(r2);
            if (kDipole)
              g = (dx * sdx[j] + dy * sdy[j] + dz * sdz[j]) * (g * g * g);
            val_axpy(acc, g, sq[j]);
          }
        }
      }
    }
    if (active) out[t0 + ti] = acc;
  }
}

template <typename T, typename V, bool kDipole>
int p2p(const void* targets, long long ntargets, const void* sources,
        long long nsources, const void* charges, const void* dipoles,
        const void* bts, const void* btc, const void* bss, const void* bsc,
        const void* target_boxes, long long nrows, const void* starts,
        const void* lists, void* out, void* stream) {
  if (nrows > 0) {
    p2p_kernel<T, V, kDipole>
        <<<(unsigned)nrows, kP2PThreads, 0, (cudaStream_t)stream>>>(
            (const T*)targets, ntargets, (const T*)sources, nsources,
            (const V*)charges, (const T*)dipoles, (const int*)bts,
            (const int*)btc, (const int*)bss, (const int*)bsc,
            (const int*)target_boxes, (const int*)starts, (const int*)lists,
            (V*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_P2P_ENTRY(suffix, T, V)                                \
  extern "C" int p2p_laplace3d_##suffix(                                    \
      const void* targets, long long ntargets, const void* sources,         \
      long long nsources, const void* charges, const void* bts,             \
      const void* btc, const void* bss, const void* bsc,                    \
      const void* target_boxes, long long nrows, const void* starts,        \
      const void* lists, void* out, void* stream) {                         \
    return boxtree_torch::p2p<T, V, false>(                                 \
        targets, ntargets, sources, nsources, charges, nullptr, bts, btc,   \
        bss, bsc, target_boxes, nrows, starts, lists, out, stream);         \
  }                                                                         \
  extern "C" int p2p_laplace3d_dipole_##suffix(                             \
      const void* targets, long long ntargets, const void* sources,         \
      long long nsources, const void* charges, const void* dipoles,         \
      const void* bts, const void* btc, const void* bss, const void* bsc,   \
      const void* target_boxes, long long nrows, const void* starts,        \
      const void* lists, void* out, void* stream) {                         \
    return boxtree_torch::p2p<T, V, true>(                                  \
        targets, ntargets, sources, nsources, charges, dipoles, bts, btc,   \
        bss, bsc, target_boxes, nrows, starts, lists, out, stream);         \
  }

BOXTREE_TORCH_P2P_ENTRY(f32, float, float)
BOXTREE_TORCH_P2P_ENTRY(f64, double, double)
BOXTREE_TORCH_P2P_ENTRY(c128, double, double2)
