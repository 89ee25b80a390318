// K12 stick_levels and K13 box_extents: the two device programs of the
// tree build with particle extents (radii).
//
// K12 replaces boxtree_tpu/tree/build.py:85 _stick_levels: for every
// particle, the deepest level whose cell, enlarged by the stick-out
// factor, still holds the particle with its radius (l-inf or l2 norm).
// It feeds the tree's structure, so it must equal the plain version
// (boxtree_torch/ops/extents.py) bit for bit: every float step runs in the
// coordinates' own type and in the reference's order, spelled with the
// *_rn intrinsics of common.cuh so that nothing is contracted into an FMA.
//
// K13 replaces boxtree_tpu/tree/build.py:536 _box_extents: each box's
// bounding box of its particles +- radius, combined bottom-up.  Every box
// starts at its own centre (an empty box reflects its centre).  After the
// extent re-sort of phase B a box's own ("nonchild") particles are one
// contiguous range, so the first launch takes one thread per box over its
// range; then one launch per level, finest first, takes one thread per
// box and folds in its children (box_child_ids), which are final by then.
// min and max do not depend on the order, so no atomics are needed and the
// result equals the plain version's scatter exactly.
//
// Bound: memory.  K12 reads d + 1 values and writes one int32 per particle;
// its level loop (at most 31 steps of a few operations) stays in
// registers.  K13 reads each particle once and each box's bounds a few
// times.  One thread per particle or box, coalesced where the data allows.
#include "common.cuh"

namespace boxtree_torch {
namespace {

template <typename T>
__global__ void stick_levels_kernel(const T* __restrict__ coords,
                                    const T* __restrict__ radii, long long n,
                                    const T* __restrict__ bbox_min,
                                    const T* __restrict__ root_extent, int d,
                                    int depth, int l2, T sof1,
                                    int* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T extent = *root_extent;
  const T nbuckets = (T)(1ll << depth);
  const long long top = (1ll << depth) - 1;
  T x[3], lo[3];
  long long cell[3];
  for (int ax = 0; ax < d; ++ax) {
    x[ax] = coords[ax * n + i];
    lo[ax] = bbox_min[ax];
    // cells_from_coords (boxtree_tpu/ops/morton.py), as K1 computes it
    const T scaled = div_rn(sub_rn(x[ax], lo[ax]), extent);
    long long c = (long long)floor_t(mul_rn(scaled, nbuckets));
    cell[ax] = c < 0 ? 0 : (c > top ? top : c);
  }
  const T r = radii[i];
  int stick = 0;
  for (int lev = 1; lev <= depth; ++lev) {
    const T size = div_rn(extent, (T)(1ll << lev));
    const T half = div_rn(size, (T)2);
    const T sor = mul_rn(sof1, half);
    bool fits = true;
    T sq = 0;
    for (int ax = 0; ax < d; ++ax) {
      // bbox_min + cell * size + size / 2, left to right
      const T c = add_rn(add_rn(lo[ax], mul_rn((T)(cell[ax] >> (depth - lev)),
                                               size)),
                         half);
      if (l2) {
        const T dx = sub_rn(x[ax], c);
        sq = ax == 0 ? mul_rn(dx, dx) : add_rn(sq, mul_rn(dx, dx));
      } else {
        fits = fits && add_rn(x[ax], r) < add_rn(c, sor) &&
               sub_rn(x[ax], r) >= sub_rn(c, sor);
      }
    }
    if (l2) {
      const T dist = add_rn(sqrt_rn(sq), r);
      fits = mul_rn(dist, dist) < mul_rn(mul_rn((T)d, sor), sor);
    }
    if (!fits) break;
    ++stick;
  }
  out[i] = stick;
}

template <typename T>
__global__ void box_extents_own_kernel(const T* __restrict__ coords,
                                       const T* __restrict__ radii,
                                       long long n,
                                       const int* __restrict__ starts,
                                       const int* __restrict__ counts,
                                       const T* __restrict__ centers,
                                       long long nboxes, int d,
                                       T* __restrict__ bmin,
                                       T* __restrict__ bmax) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nboxes) return;
  const long long p0 = starts[b], p1 = p0 + counts[b];
  for (int ax = 0; ax < d; ++ax) {
    T lo = centers[ax * nboxes + b], hi = lo;
    for (long long p = p0; p < p1; ++p) {
      const T x = coords[ax * n + p];
      const T r = radii ? radii[p] : (T)0;
      const T a = sub_rn(x, r), c = add_rn(x, r);
      lo = a < lo ? a : lo;
      hi = c > hi ? c : hi;
    }
    bmin[ax * nboxes + b] = lo;
    bmax[ax * nboxes + b] = hi;
  }
}

template <typename T>
__global__ void box_extents_up_kernel(long long b0, long long b1,
                                      const int* __restrict__ child_ids,
                                      long long nboxes, int d,
                                      T* __restrict__ bmin,
                                      T* __restrict__ bmax) {
  const long long b = b0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= b1) return;
  const int nchild = 1 << d;
  for (int ax = 0; ax < d; ++ax) {
    T lo = bmin[ax * nboxes + b], hi = bmax[ax * nboxes + b];
    for (int q = 0; q < nchild; ++q) {
      const long long c = child_ids[q * nboxes + b];
      if (c <= 0) continue;
      const T a = bmin[ax * nboxes + c], e = bmax[ax * nboxes + c];
      lo = a < lo ? a : lo;
      hi = e > hi ? e : hi;
    }
    bmin[ax * nboxes + b] = lo;
    bmax[ax * nboxes + b] = hi;
  }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
int stick_levels(const void* coords, const void* radii, long long n,
                 const void* bbox_min, const void* root_extent, long long d,
                 long long depth, long long l2, double sof1, void* out,
                 void* stream) {
  if (n > 0)
    stick_levels_kernel<T><<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const T*)coords, (const T*)radii, n, (const T*)bbox_min,
        (const T*)root_extent, (int)d, (int)depth, (int)l2, (T)sof1,
        (int*)out);
  return (int)cudaGetLastError();
}

// b0 < 0: the first launch, every box over its own particles (has_radii
// 0 takes the radii as 0 and does not read them); else one level's boxes
// [b0, b1) fold in their children
template <typename T>
int box_extents(const void* coords, const void* radii, long long has_radii,
                long long n, const void* starts, const void* counts,
                const void* centers, const void* child_ids, long long nboxes,
                long long b0, long long b1, long long d, void* bmin,
                void* bmax, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b0 < 0) {
    if (nboxes > 0)
      box_extents_own_kernel<T><<<blocks_for(nboxes), kThreads, 0, s>>>(
          (const T*)coords, has_radii ? (const T*)radii : nullptr, n,
          (const int*)starts, (const int*)counts, (const T*)centers, nboxes,
          (int)d, (T*)bmin, (T*)bmax);
  } else if (b1 > b0) {
    box_extents_up_kernel<T><<<blocks_for(b1 - b0), kThreads, 0, s>>>(
        b0, b1, (const int*)child_ids, nboxes, (int)d, (T*)bmin, (T*)bmax);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define STICK_LEVELS_ENTRY(SUFFIX, T)                                       \
  extern "C" int stick_levels_##SUFFIX(                                     \
      const void* coords, const void* radii, long long n,                  \
      const void* bbox_min, const void* root_extent, long long d,          \
      long long depth, long long l2, double sof1, void* out,               \
      void* stream) {                                                       \
    return boxtree_torch::stick_levels<T>(coords, radii, n, bbox_min,       \
                                          root_extent, d, depth, l2, sof1,  \
                                          out, stream);                     \
  }
STICK_LEVELS_ENTRY(f32, float)
STICK_LEVELS_ENTRY(f64, double)

#define BOX_EXTENTS_ENTRY(SUFFIX, T)                                        \
  extern "C" int box_extents_##SUFFIX(                                      \
      const void* coords, const void* radii, long long has_radii,          \
      long long n, const void* starts, const void* counts,                 \
      const void* centers, const void* child_ids, long long nboxes,        \
      long long b0, long long b1, long long d, void* bmin, void* bmax,     \
      void* stream) {                                                       \
    return boxtree_torch::box_extents<T>(coords, radii, has_radii, n,       \
                                         starts, counts, centers,           \
                                         child_ids, nboxes, b0, b1, d,      \
                                         bmin, bmax, stream);               \
  }
BOX_EXTENTS_ENTRY(f32, float)
BOX_EXTENTS_ENTRY(f64, double)
