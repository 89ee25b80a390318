// K43 tree_leaf_levels, K44 tree_level_boxes and K46 level_box_counts: the
// tree build's phases A and B and the level restriction's recount.
//
// K43 replaces boxtree_tpu/tree/build.py:113 _phase_a (its level loop
// :197-241 with _seg_totals :71 and _prefix_segments :55): every sorted
// particle's leaf level, the boxes of every level, and the particles still
// in overfull boxes, in one launch per depth tried.  The reference walks
// the levels all particles at a time, with a host check between levels;
// here one thread walks one particle's levels.  Its level-l box is the key
// range [lower_bound(p << s), lower_bound((p + 1) << s)) of the sorted keys
// (p its level-l prefix, s = d (depth - l)), found by binary searches that
// narrow level by level (a box lies inside its parent's range), and the
// box's refine weight is a difference of an exclusive cumulative sum of
// the sorted weights (a library cumsum, hoisted as the reference hoists
// it; unit weights need none).  The particle's leaf is the first level at
// which that weight is at most the maximum; a box's particles walk the
// same ranges, so they stop together, as the reference assigns them.
// Particle i then starts a level-l box exactly for l in (lcp_i, leaf_i],
// lcp_i the deepest level at which its key shares its prefix with i - 1's.
// With extents a particle also stops at its stick level, and a box's
// weight counts only the particles that can still descend: the range sum
// of w [stick > l], read from one (levels x (n + 1)) table of exclusive
// cumulative sums (a library cumsum along its rows).  Stopped particles
// may then sit between active ones inside one prefix range, so a second
// kernel counts the prefix ranges that hold an active particle: every run
// start of active particles (l in (min(lcp_i, leaf_{i-1}), leaf_i]) sets
// bit l of a tag at its range's first position, and counts if the bit was
// clear.  The non-adaptive kind reduces the largest box weight of every
// level (each box once, from its first particle) and the number of boxes
// of every level, then one thread takes the first level whose largest
// weight fits, clears the counts below it and a third kernel gives every
// particle that level.  Counts, the unfit count and the level used go to
// one int64 array, which the host reads once.
//
// K44 replaces the level loop of boxtree_tpu/tree/build.py:262 _phase_b
// (:337-419), one launch a level.  The wrapper gives it that level's box
// starts' inclusive scan (a library cumsum, the reference's seg_id), so
// particle i's box is b0 + seg_i - 1.  At a box start it writes the box's
// prefix, level, first particle, cumulative and own counts, child flag,
// centre, parent (the particle's box one level up) and the parent's child
// slot; every active particle records its box (and its leaf box at its
// leaf level).  Without extents the box's subtree ends at
// lower_bound((p + 1) << s), equal to the reference's reverse cummin on
// sorted keys; with extents the counts are differences of the cumulative
// counts of particles at or below the level (:375-379) up to the next box
// start, found by a binary search in the scan.  Centres are bbox_min +
// (cell + 0.5) size in the coordinates' type, each step rounded as torch
// rounds it (no FMA; the cell converted with round-to-nearest).
//
// K46 replaces boxtree_tpu/tree/level_restrict.py:123 _recount_boxes: a
// particle starts a level-l run of active particles exactly for l in
// (min(lcp_i, leaf_{i-1}), leaf_i]; one launch adds these ranges up for
// every level at once.
//
// The level histograms of K43 and K46 add ranges into a per-block
// difference array in shared memory, prefix-summed once a block and added
// to global memory with one atomic per level.
//
// Bound: memory latency.  The binary searches are chains of dependent
// loads (about log2 of the parent's range each), which the byte bound does
// not see; threads of one warp search neighbouring ranges, so most loads
// hit in cache.
#include <climits>

#include "common.cuh"
#include "levels.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

constexpr int kThreads = 256;

// {{{ K43

// the adaptive kind: one thread walks one particle's levels
template <bool EXT>
__global__ void leaf_walk_kernel(const int64_t* __restrict__ codes,
                                 long long n,
                                 const int64_t* __restrict__ cumw,
                                 const int64_t* __restrict__ table,
                                 const int* __restrict__ stick,
                                 long long max_w, int d, int depth,
                                 int* __restrict__ leaf,
                                 unsigned long long* __restrict__ packed) {
  __shared__ int diff[kMaxLevels + 1];
  __shared__ unsigned long long unfit;
  LevelHistogram hist{diff};
  hist.clear();
  if (threadIdx.x == 0) unfit = 0;
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    const int64_t code = codes[i];
    const int st = EXT ? stick[i] : depth + 1;
    long long lo = 0, hi = n;
    int lf = -1;
    for (int l = 0; l <= depth; ++l) {
      const int s = d * (depth - l);
      if (l > 0) {
        const int64_t p = code >> s;
        lo = lower_bound_in(codes, lo, i, p << s);
        hi = lower_bound_in(codes, i + 1, hi, (p + 1) << s);
      }
      long long w;
      if (EXT) {
        const int64_t* row = table + (long long)l * (n + 1);
        w = row[hi] - row[lo];
      } else {
        w = cumw ? cumw[hi] - cumw[lo] : hi - lo;
      }
      if (st <= l || w <= max_w) {
        lf = l;
        break;
      }
    }
    if (lf < 0) {
      lf = depth;
      atomicAdd(&unfit, 1ull);
    }
    leaf[i] = lf;
    if (!EXT) hist.add_range(lcp_level(codes, i, d, depth), lf);
  }
  __syncthreads();
  if (threadIdx.x == 0 && unfit) atomicAdd(&packed[depth + 2], unfit);
  if (!EXT) hist.flush(packed, depth + 2);
}

// with extents: the prefix ranges of every level that hold an active
// particle, counted once each through the tags at their first positions
__global__ void extent_count_kernel(const int64_t* __restrict__ codes,
                                    long long n, const int* __restrict__ leaf,
                                    int d, int depth,
                                    unsigned long long* __restrict__ tags,
                                    unsigned long long* __restrict__ packed) {
  __shared__ int count[kMaxLevels];
  for (int l = threadIdx.x; l < kMaxLevels; l += blockDim.x) count[l] = 0;
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    const int64_t code = codes[i];
    const int lf = leaf[i];
    const int lcp = lcp_level(codes, i, d, depth);
    const int thr = i == 0 ? -1 : min(lcp, leaf[i - 1]);
    for (int l = thr + 1; l <= lf; ++l) {
      const int s = d * (depth - l);
      // a run that starts inside its prefix range (an inactive particle
      // before it) finds the range's first position
      const long long first =
          l > lcp ? i : lower_bound_in(codes, 0, i, (code >> s) << s);
      const unsigned long long bit = 1ull << l;
      if (!(atomicOr(&tags[first], bit) & bit)) atomicAdd(&count[l], 1);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l <= depth; l += blockDim.x)
    if (count[l]) atomicAdd(&packed[l], (unsigned long long)count[l]);
}

// the non-adaptive kind: each box's weight from its first particle, the
// largest of each level, and the boxes of every level
__global__ void level_max_kernel(const int64_t* __restrict__ codes,
                                 long long n,
                                 const int64_t* __restrict__ cumw, int d,
                                 int depth, long long* __restrict__ maxw,
                                 unsigned long long* __restrict__ packed) {
  __shared__ int diff[kMaxLevels + 1];
  __shared__ long long smax[kMaxLevels];
  LevelHistogram hist{diff};
  hist.clear();
  for (int l = threadIdx.x; l < kMaxLevels; l += blockDim.x)
    smax[l] = LLONG_MIN;
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    const int64_t code = codes[i];
    const int lcp = lcp_level(codes, i, d, depth);
    long long hi = n;
    for (int l = lcp + 1; l <= depth; ++l) {
      const int s = d * (depth - l);
      hi = lower_bound_in(codes, i + 1, hi, ((code >> s) + 1) << s);
      const long long w = cumw ? cumw[hi] - cumw[i] : hi - i;
      atomicMax(&smax[l], w);
    }
    hist.add_range(lcp, depth);
  }
  __syncthreads();
  for (int l = threadIdx.x; l <= depth; l += blockDim.x)
    if (smax[l] != LLONG_MIN) atomicMax(&maxw[l], smax[l]);
  hist.flush(packed, depth + 2);
}

__global__ void level_used_kernel(const long long* __restrict__ maxw,
                                  long long max_w, long long n, int depth,
                                  long long* __restrict__ packed) {
  int used = -1;
  for (int l = 0; l <= depth; ++l)
    if (maxw[l] <= max_w) {
      used = l;
      break;
    }
  if (used >= 0) {
    for (int l = used + 1; l <= depth + 1; ++l) packed[l] = 0;
    packed[depth + 2] = 0;
    packed[depth + 3] = used;
  } else {
    packed[depth + 2] = n;
    packed[depth + 3] = depth;
  }
}

__global__ void fill_leaf_kernel(int* __restrict__ leaf, long long n,
                                 const long long* __restrict__ packed,
                                 int depth) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) leaf[i] = (int)packed[depth + 3];
}

// }}}

// {{{ K44

__device__ __forceinline__ float cell_to(float, long long c) {
  return __ll2float_rn(c);
}
__device__ __forceinline__ double cell_to(double, long long c) {
  return __ll2double_rn(c);
}

template <typename T>
__global__ void level_boxes_kernel(
    const int64_t* __restrict__ codes, long long n,
    const int* __restrict__ leaf, const int* __restrict__ thr,
    const int* __restrict__ seg, const int64_t* __restrict__ cum_ge,
    const int64_t* __restrict__ cum_gt, int has_ext, int level, long long b0,
    long long cap, int d, int depth, const T* __restrict__ bbox_min,
    const T* __restrict__ root_extent, int64_t* __restrict__ box_morton,
    int* __restrict__ box_level, int64_t* __restrict__ box_start,
    int64_t* __restrict__ box_cumul, int64_t* __restrict__ box_nonchild,
    bool* __restrict__ box_has_children, int* __restrict__ box_parent,
    int* __restrict__ box_child, T* __restrict__ box_centers,
    int* __restrict__ prev_box, int* __restrict__ leaf_box) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lf = leaf[i];
  if (lf < level) return;
  const int b = (int)(b0 + seg[i] - 1);
  if (lf == level) leaf_box[i] = b;
  if (thr[i] < level) {
    const int s = d * (depth - level);
    const int64_t p = codes[i] >> s;
    box_morton[b] = p;
    box_level[b] = level;
    box_start[b] = i;
    long long cumul, deeper;
    if (has_ext) {
      const long long next = upper_bound_in(seg, i + 1, n, seg[i]);
      cumul = cum_ge[next] - cum_ge[i];
      deeper = cum_gt[next] - cum_gt[i];
    } else {
      cumul = lower_bound_in(codes, i + 1, n, (p + 1) << s) - i;
      deeper = lf > level ? cumul : 0;
    }
    box_cumul[b] = cumul;
    box_nonchild[b] = cumul - deeper;
    box_has_children[b] = deeper > 0;
    int64_t cells[3];
    deinterleave_code(p, d, cells);
    const T size = div_rn(root_extent[0], (T)(1ull << level));
    for (int ax = 0; ax < d; ++ax)
      box_centers[ax * cap + b] = add_rn(
          bbox_min[ax],
          mul_rn(add_rn(cell_to(T(), cells[ax]), (T)0.5), size));
    if (level > 0) {
      const int parent = prev_box[i];
      box_parent[b] = parent;
      box_child[(long long)(p & ((1 << d) - 1)) * cap + parent] = b;
    }
  }
  prev_box[i] = b;
}

// }}}

// {{{ K46

__global__ void level_counts_kernel(const int64_t* __restrict__ codes,
                                    long long n, const int* __restrict__ leaf,
                                    int d, int depth, int max_level,
                                    unsigned long long* __restrict__ counts) {
  __shared__ int diff[kMaxLevels + 1];
  LevelHistogram hist{diff};
  hist.clear();
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    const int thr =
        i == 0 ? -1 : min(lcp_level(codes, i, d, depth), leaf[i - 1]);
    hist.add_range(thr, min(leaf[i], max_level));
  }
  __syncthreads();
  hist.flush(counts, depth + 2);
}

// }}}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int tree_leaf_levels(const void* codes, long long n,
                                const void* cumw, long long has_w,
                                const void* table, const void* stick,
                                long long has_ext, long long max_w,
                                long long adaptive, long long d,
                                long long depth, void* leaf, void* packed,
                                void* maxw, void* tags, void* stream) {
  using namespace boxtree_torch;
  if (n <= 0) return (int)cudaGetLastError();
  if (depth + 2 > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* k = (const int64_t*)codes;
  const int64_t* w = has_w ? (const int64_t*)cumw : nullptr;
  auto* out = (unsigned long long*)packed;
  if (!adaptive) {
    level_max_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        k, n, w, (int)d, (int)depth, (long long*)maxw, out);
    level_used_kernel<<<1, 1, 0, s>>>((const long long*)maxw, max_w, n,
                                      (int)depth, (long long*)packed);
    fill_leaf_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (int*)leaf, n, (const long long*)packed, (int)depth);
  } else if (has_ext) {
    leaf_walk_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        k, n, nullptr, (const int64_t*)table, (const int*)stick, max_w,
        (int)d, (int)depth, (int*)leaf, out);
    extent_count_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        k, n, (const int*)leaf, (int)d, (int)depth,
        (unsigned long long*)tags, out);
  } else {
    leaf_walk_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        k, n, w, nullptr, nullptr, max_w, (int)d, (int)depth, (int*)leaf,
        out);
  }
  return (int)cudaGetLastError();
}

#define TREE_LEVEL_BOXES_ENTRY(SUFFIX, T)                                    \
  extern "C" int tree_level_boxes_##SUFFIX(                                  \
      const void* codes, long long n, const void* leaf, const void* thr,     \
      const void* seg, const void* cum_ge, const void* cum_gt,               \
      long long has_ext, long long level, long long b0, long long cap,       \
      long long d, long long depth, const void* bbox_min,                    \
      const void* root_extent, void* box_morton, void* box_level,            \
      void* box_start, void* box_cumul, void* box_nonchild,                  \
      void* box_has_children, void* box_parent, void* box_child,             \
      void* box_centers, void* prev_box, void* leaf_box, void* stream) {     \
    using namespace boxtree_torch;                                           \
    if (n > 0)                                                               \
      level_boxes_kernel<T><<<blocks_for(n), kThreads, 0,                    \
                              (cudaStream_t)stream>>>(                       \
          (const int64_t*)codes, n, (const int*)leaf, (const int*)thr,       \
          (const int*)seg, (const int64_t*)cum_ge, (const int64_t*)cum_gt,   \
          (int)has_ext, (int)level, b0, cap, (int)d, (int)depth,             \
          (const T*)bbox_min, (const T*)root_extent, (int64_t*)box_morton,   \
          (int*)box_level, (int64_t*)box_start, (int64_t*)box_cumul,         \
          (int64_t*)box_nonchild, (bool*)box_has_children,                   \
          (int*)box_parent, (int*)box_child, (T*)box_centers,                \
          (int*)prev_box, (int*)leaf_box);                                   \
    return (int)cudaGetLastError();                                          \
  }
TREE_LEVEL_BOXES_ENTRY(f32, float)
TREE_LEVEL_BOXES_ENTRY(f64, double)

extern "C" int level_box_counts(const void* codes, long long n,
                                const void* leaf, long long d,
                                long long depth, long long max_level,
                                void* counts, void* stream) {
  using namespace boxtree_torch;
  if (depth + 2 > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n > 0)
    level_counts_kernel<<<blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int64_t*)codes, n, (const int*)leaf, (int)d, (int)depth,
        (int)max_level, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
