// K2 p2p_laplace3d: List-1 direct evaluation, phi(t) = sum q_s / |t - s|
// over the source particles of every List-1 box of t's box, skipping r = 0.
//
// Replaces boxtree_tpu/models/expansion_base.py:1258 _eval_direct_rowmajor
// with boxtree_tpu/models/laplace.py:492 _p2p.  Unlike the reference it
// builds no padded particle blocks and no bucketed row maps
// (expansion_base.py:1215-1244): a box's nonchild particles are the
// contiguous tree-order range [box_*_starts, + box_*_counts_nonchild).
//
// Bound: arithmetic.  Each pair costs ~10 flops plus one rsqrt on the SFU
// and reads 16 bytes from shared memory, while each source particle is read
// from device memory once per target box that lists it (~22 boxes of <= 30
// particles per row at 1e6 points): pairs outnumber global loads 30 to 1.
// One CTA (one warp) per target box, one thread per target particle; the
// source boxes stream through shared memory in warp-sized tiles, and every
// thread keeps its sum in a register and writes its potential once.
#include "common.cuh"

namespace boxtree_torch {
namespace {

constexpr int kP2PThreads = 32;

template <typename T>
__global__ void __launch_bounds__(kP2PThreads)
p2p_kernel(const T* __restrict__ targets, long long ntargets,
           const T* __restrict__ sources, long long nsources,
           const T* __restrict__ charges,
           const int* __restrict__ box_target_starts,
           const int* __restrict__ box_target_counts,
           const int* __restrict__ box_source_starts,
           const int* __restrict__ box_source_counts,
           const int* __restrict__ target_boxes,
           const int* __restrict__ starts, const int* __restrict__ lists,
           T* __restrict__ out) {
  __shared__ T sx[kP2PThreads], sy[kP2PThreads], sz[kP2PThreads],
      sq[kP2PThreads];
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
    T acc = T(0);
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
        }
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const T dx = tx - sx[j], dy = ty - sy[j], dz = tz - sz[j];
          const T r2 = dx * dx + dy * dy + dz * dz;
          if (r2 > T(0)) acc += sq[j] * rsqrt_t(r2);
        }
      }
    }
    if (active) out[t0 + ti] = acc;
  }
}

template <typename T>
int p2p(const void* targets, long long ntargets, const void* sources,
        long long nsources, const void* charges, const void* bts,
        const void* btc, const void* bss, const void* bsc,
        const void* target_boxes, long long nrows, const void* starts,
        const void* lists, void* out, void* stream) {
  if (nrows > 0) {
    p2p_kernel<T><<<(unsigned)nrows, kP2PThreads, 0, (cudaStream_t)stream>>>(
        (const T*)targets, ntargets, (const T*)sources, nsources,
        (const T*)charges, (const int*)bts, (const int*)btc,
        (const int*)bss, (const int*)bsc, (const int*)target_boxes,
        (const int*)starts, (const int*)lists, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_P2P_ENTRY(suffix, T)                                   \
  extern "C" int p2p_laplace3d_##suffix(                                    \
      const void* targets, long long ntargets, const void* sources,         \
      long long nsources, const void* charges, const void* bts,             \
      const void* btc, const void* bss, const void* bsc,                    \
      const void* target_boxes, long long nrows, const void* starts,        \
      const void* lists, void* out, void* stream) {                         \
    return boxtree_torch::p2p<T>(targets, ntargets, sources, nsources,      \
                                 charges, bts, btc, bss, bsc, target_boxes, \
                                 nrows, starts, lists, out, stream);        \
  }

BOXTREE_TORCH_P2P_ENTRY(f32, float)
BOXTREE_TORCH_P2P_ENTRY(f64, double)
