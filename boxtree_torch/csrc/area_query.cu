// K6 area_query_sweep and K7 space_invader_sweep: one level of the
// level-by-level area-query sweep.
//
// K6 replaces boxtree_tpu/geometry/area_query.py:86 _expand_frontier and
// :108 _compact_frontier; K7 replaces the space-invader query of
// :259-286 (area_query_elementwise with combine="max").  The host loop,
// the root-is-leaf branch and the final torch.sort of the keys stay in
// boxtree_torch/ops/area_query.py.
//
// Bound: memory.  Each (frontier pair, child digit) reads the child's id,
// level, flag and centre and the ball's centre and radius (about 40 bytes
// in float64) and appends a 8-byte key or a 8-byte pair; the test is a
// handful of float operations.  One thread per (pair, digit), so a level's
// pairs are all in flight; the appends go through one device counter per
// buffer into buffers of capacity 2^d F, in no fixed order (the keys are
// sorted afterwards, and the next frontier's order changes no result).
//
// The overlap test is the reference's, in the coordinates' type and order:
// children > 0, dist = max_i |c_i - b_i|, dist <= root_extent /
// (1 << (level + 1)) + r, with an IEEE divide and nothing an FMA could
// contract (no fast-math flag).  K7 casts the hit's distance to float32
// and takes atomicMax of its int bits: non-negative floats order as their
// bit patterns, so the maximum equals the reference's scatter-max.
#include "common.cuh"

namespace boxtree_torch {
namespace {

constexpr int kIsLeafBox = 1 << 4;

template <typename T>
struct SweepArgs {
  const int* ball_idx;
  const int* box_idx;
  long long f;
  const T* centers;
  long long nballs;
  const T* radii;
  const int* child_ids;
  long long nboxes;
  const T* box_centers;
  const int* box_levels;
  const int* box_flags;
  const T* root_extent;
  int d;
};

// the overlap of child `digit` of frontier pair `p`; returns the child id
// (0 for none) and its distance to the ball's centre
template <typename T>
__device__ __forceinline__ int overlapping_child(const SweepArgs<T>& a,
                                                 long long p, int digit,
                                                 T* dist_out) {
  const int ball = a.ball_idx[p];
  const int child = a.child_ids[digit * a.nboxes + a.box_idx[p]];
  if (child <= 0) return 0;
  T dist = 0;
  for (int ax = 0; ax < a.d; ++ax) {
    const T diff = a.box_centers[ax * a.nboxes + child] -
                   a.centers[ax * a.nballs + ball];
    const T ad = diff < 0 ? -diff : diff;
    dist = ax == 0 ? ad : (ad > dist ? ad : dist);
  }
  const T crad = *a.root_extent / (T)(1ll << (a.box_levels[child] + 1));
  *dist_out = dist;
  return dist <= crad + a.radii[ball] ? child : 0;
}

template <typename T>
__global__ void area_query_sweep_kernel(
    SweepArgs<T> a, int64_t* __restrict__ hits, int* __restrict__ next_ball,
    int* __restrict__ next_box, unsigned long long* __restrict__ counts) {
  const int nchild = 1 << a.d;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= a.f * nchild) return;
  const long long p = t / nchild;
  T dist;
  const int child = overlapping_child(a, p, (int)(t % nchild), &dist);
  if (!child) return;
  const int ball = a.ball_idx[p];
  if (a.box_flags[child] & kIsLeafBox) {
    const unsigned long long slot = atomicAdd(&counts[0], 1ull);
    hits[slot] = ((int64_t)ball << 32) | (int64_t)child;
  } else {
    const unsigned long long slot = atomicAdd(&counts[1], 1ull);
    next_ball[slot] = ball;
    next_box[slot] = child;
  }
}

template <typename T>
__global__ void space_invader_sweep_kernel(
    SweepArgs<T> a, float* __restrict__ out, int* __restrict__ next_ball,
    int* __restrict__ next_box, unsigned long long* __restrict__ count) {
  const int nchild = 1 << a.d;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= a.f * nchild) return;
  const long long p = t / nchild;
  T dist;
  const int child = overlapping_child(a, p, (int)(t % nchild), &dist);
  if (!child) return;
  if (a.box_flags[child] & kIsLeafBox) {
    atomicMax((int*)&out[child], __float_as_int((float)dist));
  } else {
    const unsigned long long slot = atomicAdd(count, 1ull);
    next_ball[slot] = a.ball_idx[p];
    next_box[slot] = child;
  }
}

template <typename T>
SweepArgs<T> sweep_args(const void* ball_idx, const void* box_idx,
                        long long f, const void* centers, long long nballs,
                        const void* radii, const void* child_ids,
                        long long nboxes, const void* box_centers,
                        const void* box_levels, const void* box_flags,
                        const void* root_extent, long long d) {
  return SweepArgs<T>{(const int*)ball_idx, (const int*)box_idx, f,
                      (const T*)centers, nballs, (const T*)radii,
                      (const int*)child_ids, nboxes, (const T*)box_centers,
                      (const int*)box_levels, (const int*)box_flags,
                      (const T*)root_extent, (int)d};
}

constexpr int kThreads = 256;

inline unsigned sweep_blocks(long long f, long long d) {
  return (unsigned)((f * (1ll << d) + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace boxtree_torch

#define SWEEP_PARAMS                                                       \
  const void *ball_idx, const void *box_idx, long long f,                  \
      const void *centers, long long nballs, const void *radii,            \
      const void *child_ids, long long nboxes, const void *box_centers,    \
      const void *box_levels, const void *box_flags,                       \
      const void *root_extent, long long d
#define SWEEP_ARGS                                                         \
  ball_idx, box_idx, f, centers, nballs, radii, child_ids, nboxes,         \
      box_centers, box_levels, box_flags, root_extent, d

#define DEFINE_SWEEP(SUFFIX, T)                                            \
  extern "C" int area_query_sweep_##SUFFIX(SWEEP_PARAMS, void* hits,       \
                                           void* next_ball,                \
                                           void* next_box, void* counts,   \
                                           void* stream) {                 \
    using namespace boxtree_torch;                                         \
    if (f > 0)                                                             \
      area_query_sweep_kernel<T>                                           \
          <<<sweep_blocks(f, d), kThreads, 0, (cudaStream_t)stream>>>(     \
              sweep_args<T>(SWEEP_ARGS), (int64_t*)hits, (int*)next_ball,  \
              (int*)next_box, (unsigned long long*)counts);                \
    return (int)cudaGetLastError();                                        \
  }                                                                        \
  extern "C" int space_invader_sweep_##SUFFIX(SWEEP_PARAMS, void* out,     \
                                              void* next_ball,             \
                                              void* next_box, void* count, \
                                              void* stream) {              \
    using namespace boxtree_torch;                                         \
    if (f > 0)                                                             \
      space_invader_sweep_kernel<T>                                        \
          <<<sweep_blocks(f, d), kThreads, 0, (cudaStream_t)stream>>>(     \
              sweep_args<T>(SWEEP_ARGS), (float*)out, (int*)next_ball,     \
              (int*)next_box, (unsigned long long*)count);                 \
    return (int)cudaGetLastError();                                        \
  }

DEFINE_SWEEP(f32, float)
DEFINE_SWEEP(f64, double)
