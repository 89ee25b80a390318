// K14 list4_ext and K15 list3_ext: Lists 4 and 3 of a traversal whose
// targets have extents, each with its "close" half.
//
// K14 replaces the with-extent branch of boxtree_tpu/traversal/build.py:
// 264 _gen_list4 (:288-301) and :499 _gen_list4_close; K15 replaces :398
// _gen_list3_ext (far per source level, and close).  The plain versions
// are the generators of boxtree_torch/ops/close_lists.py; both read the
// same clamped neighbour table (boxtree_torch/traversal/neighbors.py), and
// both must give the same lists, entry for entry.
//
// K14: one thread per target-or-target-parent row b at level lb >= 2.  For
// each ancestor level wl in 1..lb-1 it reads the 3^d - 1 non-centre
// columns of the clamped table row of b's level-wl ancestor; an entry
// counts only if it lies at level wl.  A source box s there that does not
// touch b goes to b's List 4 if it meets the sep-bigger criterion at b
// and b's parent would not take it (touches it, or fails the criterion
// there), and to b's close List 4 if it fails the criterion at b and b is
// a target box.  A count pass, torch.cumsum in the wrapper, then a fill
// pass that writes each row ascending (one level's candidates at a time,
// sorted in registers; levels ascend, and so do box ids).
//
// K15: one thread per source box w at level ls >= 1.  For each coarser
// level lt it reads the whole clamped table row of w's level-lt ancestor;
// a target box b at level lt there that does not touch w, and whose walk
// would have come down to w (each intermediate ancestor of w touches b,
// fails the sep-smaller criterion, or is forced close by
// min_nsources), pairs with w: in List 3 at level ls if w meets the
// criterion and is not forced close, else in the close List 3 if w holds
// sources itself.  Keys (b << 32) | w go out through device counters (the
// far ones into one segment per source level) and are sorted by the
// wrapper, as K6's are.
//
// The criteria run in float64 in the reference's order (centres from the
// integer cells and the coordinates' type, then the float64 root extent
// and stick-out factor), spelled with the *_rn intrinsics of common.cuh so
// that no step is contracted into an FMA.
//
// Bound: memory latency.  Each thread does O(levels x 3^d) table reads and
// box lookups, scattered over the box arrays; the bytes that must move are
// a few per box and per emitted entry.  One thread per row keeps many
// rows' reads in flight.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

constexpr int kIsSourceBox = 1 << 0;
constexpr int kHasSourceChildBoxes = 1 << 2;
constexpr int kIdMask = (1 << 29) - 1;
constexpr int kMaxLevels = 64;
// 1 - 8 eps and 2 - 8 eps of float64 (both exact)
constexpr double kOneTol = 1.0 - 8.0 * 2.220446049250313e-16;
constexpr double kTwoTol = 2.0 - 8.0 * 2.220446049250313e-16;

enum Crit { kStaticLinf = 0, kPreciseLinf = 1, kStaticL2 = 2 };

__device__ __forceinline__ int level_of(long long b, const int64_t* lsb,
                                        int nlevels) {
  int level = 0;
  while (level + 1 < nlevels && lsb[level + 1] <= b) ++level;
  return level;
}

// offset of column j of the radius-1 table along axis ax (axis 0 slowest)
template <int D>
__device__ __forceinline__ int offset_of(int j, int ax) {
  for (int a = D - 1; a > ax; --a) j /= 3;
  return j % 3 - 1;
}

// closed boxes a (level la) and b (level lb >= la) intersect (_touch)
template <int D>
__device__ __forceinline__ bool touch(const int64_t* a, int la,
                                      const int64_t* b, int lb) {
  const int s = lb - la;
  for (int ax = 0; ax < D; ++ax) {
    const int64_t lo = a[ax] << s, hi = (a[ax] + 1) << s;
    if (!(lo <= b[ax] + 1 && b[ax] <= hi)) return false;
  }
  return true;
}

// _cells_center: bbox_min + (cell + 0.5) * (root * 2^-level), the
// parenthesis in the coordinates' type, the rest in float64
template <typename T, int D>
__device__ __forceinline__ void centre(const int64_t* cell, int level,
                                       const T* bbox_min, double root,
                                       double* out) {
  const double width = ldexp(root, -level);
  for (int ax = 0; ax < D; ++ax)
    out[ax] = add_rn((double)bbox_min[ax],
                     mul_rn((double)add_rn((T)cell[ax], (T)0.5), width));
}

__device__ __forceinline__ double level_rad(int level, double root) {
  return ldexp(root, -(level + 1));
}

// _meets_sep_bigger
template <int D>
__device__ __forceinline__ bool meets_sep_bigger(const double* tc, int tl,
                                                 const double* sc, int sl,
                                                 double root, double sof) {
  const double allowed =
      add_rn(mul_rn(mul_rn(3.0, add_rn(1.0, sof)), level_rad(tl, root)),
             level_rad(sl, root));
  double linf = 0;
  for (int ax = 0; ax < D; ++ax) {
    const double v = fabs(sub_rn(tc[ax], sc[ax]));
    linf = ax == 0 ? v : fmax(linf, v);
  }
  return linf >= mul_rn(allowed, kOneTol);
}

// _meets_sep_smaller for the three criteria; ec/rv (the target box's
// bounding-box centre and half extents) are read by precise_linf only
template <int D>
__device__ __forceinline__ bool meets_sep_smaller(
    const double* tc, int tl, const double* sc, int sl, double root,
    double sof, int crit, const double* ec, const double* rv) {
  const double src_rad = level_rad(sl, root);
  if (crit == kStaticL2) {
    const double stick = mul_rn(add_rn(1.0, sof), level_rad(tl, root));
    double sq = 0;
    for (int ax = 0; ax < D; ++ax) {
      const double v = sub_rn(tc[ax], sc[ax]);
      sq = ax == 0 ? mul_rn(v, v) : add_rn(sq, mul_rn(v, v));
    }
    const double rhs = sub_rn(
        sub_rn(sqrt_rn(sq), mul_rn(sqrt_rn((double)D), stick)), src_rad);
    return mul_rn(kTwoTol, src_rad) <= rhs;
  }
  double linf = 0;
  if (crit == kStaticLinf) {
    const double stick = mul_rn(add_rn(1.0, sof), level_rad(tl, root));
    for (int ax = 0; ax < D; ++ax) {
      const double v =
          sub_rn(sub_rn(fabs(sub_rn(tc[ax], sc[ax])), stick), src_rad);
      linf = ax == 0 ? v : fmax(linf, v);
    }
  } else {
    for (int ax = 0; ax < D; ++ax) {
      const double v =
          sub_rn(sub_rn(fabs(sub_rn(ec[ax], sc[ax])), rv[ax]), src_rad);
      linf = ax == 0 ? v : fmax(linf, v);
    }
  }
  return fmax(linf, 0.0) >= mul_rn(kTwoTol, src_rad);
}

__device__ __forceinline__ void sort_ids(int* v, int m) {
  for (int i = 1; i < m; ++i) {
    const int x = v[i];
    int k = i - 1;
    while (k >= 0 && v[k] > x) {
      v[k + 1] = v[k];
      --k;
    }
    v[k + 1] = x;
  }
}

template <typename T, int D>
__global__ void list4_ext_kernel(
    const int* __restrict__ rows, long long r0, long long r1,
    const int64_t* __restrict__ prefixes, const int* __restrict__ parents,
    const int* __restrict__ flags, const int* __restrict__ ntable,
    const int64_t* __restrict__ tgt_row_of_box,
    const int64_t* __restrict__ lsb, int nlevels,
    const T* __restrict__ bbox_min, double root, double sof,
    int* __restrict__ far_counts, int* __restrict__ close_counts,
    const int64_t* __restrict__ far_starts, int* __restrict__ far_lists,
    const int64_t* __restrict__ close_starts, int* __restrict__ close_lists,
    int fill) {
  constexpr int M = D == 2 ? 9 : 27;
  const long long r = r0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= r1) return;
  const int b = rows[r];
  const int lb = level_of(b, lsb, nlevels);
  if (lb < 2) return;
  int64_t cells[D], pcells[D], cand[D];
  deinterleave_code(prefixes[b], D, cells);
  for (int ax = 0; ax < D; ++ax) pcells[ax] = cells[ax] >> 1;
  double bc[D], pc[D], sc[D];
  centre<T, D>(cells, lb, bbox_min, root, bc);
  centre<T, D>(pcells, lb - 1, bbox_min, root, pc);
  const long long trow = tgt_row_of_box[b];
  int anc[kMaxLevels];
  anc[lb] = b;
  for (int l = lb - 1; l >= 1; --l) anc[l] = parents[anc[l + 1]];
  long long kf = fill ? far_starts[r] : 0;
  long long kc = (fill && trow >= 0) ? close_starts[trow] : 0;
  int nf = 0, nc = 0;
  for (int wl = 1; wl < lb; ++wl) {
    int far[M], close[M];
    int mf = 0, mc = 0;
    const int* trow_of = ntable + (long long)anc[wl] * M;
    for (int j = 0; j < M; ++j) {
      if (j == M / 2) continue;
      const int t = trow_of[j];
      if (t < 0) continue;
      const int id = t & kIdMask;
      if (id < lsb[wl] || !(flags[id] & kIsSourceBox)) continue;
      for (int ax = 0; ax < D; ++ax)
        cand[ax] = (cells[ax] >> (lb - wl)) + offset_of<D>(j, ax);
      if (touch<D>(cand, wl, cells, lb)) continue;
      centre<T, D>(cand, wl, bbox_min, root, sc);
      if (meets_sep_bigger<D>(bc, lb, sc, wl, root, sof)) {
        if (touch<D>(cand, wl, pcells, lb - 1) ||
            !meets_sep_bigger<D>(pc, lb - 1, sc, wl, root, sof))
          far[mf++] = id;
      } else if (trow >= 0) {
        close[mc++] = id;
      }
    }
    if (fill) {
      sort_ids(far, mf);
      for (int i = 0; i < mf; ++i) far_lists[kf++] = far[i];
      sort_ids(close, mc);
      for (int i = 0; i < mc; ++i) close_lists[kc++] = close[i];
    }
    nf += mf;
    nc += mc;
  }
  if (!fill) {
    far_counts[r] = nf;
    if (trow >= 0) close_counts[trow] = nc;
  }
}

template <typename T, int D>
__global__ void list3_ext_kernel(
    long long b0, long long b1, const int64_t* __restrict__ prefixes,
    const int* __restrict__ parents, const int* __restrict__ flags,
    const int* __restrict__ ntable,
    const int64_t* __restrict__ tgt_row_of_box,
    const int* __restrict__ src_cumul, const T* __restrict__ tbb_min,
    const T* __restrict__ tbb_max, const T* __restrict__ bbox_min,
    double root, double sof, const int64_t* __restrict__ lsb, int nlevels,
    int crit, long long min_nsources, int64_t* __restrict__ far_keys,
    const int64_t* __restrict__ far_off,
    unsigned long long* __restrict__ far_counts,
    int64_t* __restrict__ close_keys,
    unsigned long long* __restrict__ close_count) {
  constexpr int M = D == 2 ? 9 : 27;
  const long long w = b0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= b1) return;
  const int wf = flags[w];
  if (!(wf & (kIsSourceBox | kHasSourceChildBoxes))) return;
  const bool close_ok = (wf & kIsSourceBox) != 0;
  const int ls = level_of(w, lsb, nlevels);
  const long long nboxes = lsb[nlevels];
  const bool w_forced = min_nsources > 0 && src_cumul[w] < min_nsources;
  int64_t cells[D], cand[D], anc_cells[D];
  deinterleave_code(prefixes[w], D, cells);
  double wc[D], bcen[D], ac[D], ec[D], rv[D];
  centre<T, D>(cells, ls, bbox_min, root, wc);
  int anc[kMaxLevels];
  anc[ls] = (int)w;
  for (int l = ls - 1; l >= 0; --l) anc[l] = parents[anc[l + 1]];
  for (int lt = 0; lt < ls; ++lt) {
    const int* row = ntable + (long long)anc[lt] * M;
    for (int j = 0; j < M; ++j) {
      const int t = row[j];
      if (t < 0) continue;
      const int id = t & kIdMask;
      if (id < lsb[lt] || tgt_row_of_box[id] < 0) continue;
      for (int ax = 0; ax < D; ++ax)
        cand[ax] = (cells[ax] >> (ls - lt)) + offset_of<D>(j, ax);
      if (touch<D>(cand, lt, cells, ls)) continue;
      centre<T, D>(cand, lt, bbox_min, root, bcen);
      if (crit == kPreciseLinf) {
        for (int ax = 0; ax < D; ++ax) {
          const T lo = tbb_min[ax * nboxes + id];
          const T hi = tbb_max[ax * nboxes + id];
          ec[ax] = (double)mul_rn((T)0.5, add_rn(lo, hi));
          rv[ax] = (double)mul_rn((T)0.5, sub_rn(hi, lo));
        }
      }
      // the walk from b down to w: every intermediate ancestor kept it
      // descending
      bool chain = true;
      if (min_nsources > 0) {
        for (int la = lt + 1; la < ls && chain; ++la) {
          for (int ax = 0; ax < D; ++ax)
            anc_cells[ax] = cells[ax] >> (ls - la);
          if (touch<D>(cand, lt, anc_cells, la)) continue;
          if (src_cumul[anc[la]] < min_nsources) continue;
          centre<T, D>(anc_cells, la, bbox_min, root, ac);
          chain = !meets_sep_smaller<D>(bcen, lt, ac, la, root, sof, crit,
                                        ec, rv);
        }
      } else if (lt < ls - 1) {
        for (int ax = 0; ax < D; ++ax) anc_cells[ax] = cells[ax] >> 1;
        if (!touch<D>(cand, lt, anc_cells, ls - 1)) {
          centre<T, D>(anc_cells, ls - 1, bbox_min, root, ac);
          chain = !meets_sep_smaller<D>(bcen, lt, ac, ls - 1, root, sof,
                                        crit, ec, rv);
        }
      }
      if (!chain) continue;
      const int64_t key = ((int64_t)id << 32) | w;
      if (meets_sep_smaller<D>(bcen, lt, wc, ls, root, sof, crit, ec, rv) &&
          !w_forced) {
        const unsigned long long pos = atomicAdd(far_counts + ls, 1ull);
        far_keys[far_off[ls] + pos] = key;
      } else if (close_ok) {
        close_keys[atomicAdd(close_count, 1ull)] = key;
      }
    }
  }
}

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
int list4_ext(const void* rows, long long r0, long long r1,
              const void* prefixes, const void* parents, const void* flags,
              const void* ntable, const void* tgt_row_of_box,
              const void* lsb, long long nlevels, const void* bbox_min,
              double root, double sof, long long d, void* far_counts,
              void* close_counts, const void* far_starts, void* far_lists,
              const void* close_starts, void* close_lists, long long fill,
              void* stream) {
  if (r1 > r0) {
    auto kernel = d == 2 ? list4_ext_kernel<T, 2> : list4_ext_kernel<T, 3>;
    kernel<<<blocks_for(r1 - r0), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, r0, r1, (const int64_t*)prefixes,
        (const int*)parents, (const int*)flags, (const int*)ntable,
        (const int64_t*)tgt_row_of_box, (const int64_t*)lsb, (int)nlevels,
        (const T*)bbox_min, root, sof, (int*)far_counts,
        (int*)close_counts, (const int64_t*)far_starts, (int*)far_lists,
        (const int64_t*)close_starts, (int*)close_lists, (int)fill);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int list3_ext(long long b0, long long b1, const void* prefixes,
              const void* parents, const void* flags, const void* ntable,
              const void* tgt_row_of_box, const void* src_cumul,
              const void* tbb_min, const void* tbb_max, const void* bbox_min,
              double root, double sof, const void* lsb, long long nlevels,
              long long d, long long crit, long long min_nsources,
              void* far_keys, const void* far_off, void* far_counts,
              void* close_keys, void* close_count, void* stream) {
  if (b1 > b0) {
    auto kernel = d == 2 ? list3_ext_kernel<T, 2> : list3_ext_kernel<T, 3>;
    kernel<<<blocks_for(b1 - b0), kThreads, 0, (cudaStream_t)stream>>>(
        b0, b1, (const int64_t*)prefixes, (const int*)parents,
        (const int*)flags, (const int*)ntable,
        (const int64_t*)tgt_row_of_box, (const int*)src_cumul,
        (const T*)tbb_min, (const T*)tbb_max, (const T*)bbox_min, root, sof,
        (const int64_t*)lsb, (int)nlevels, (int)crit, min_nsources,
        (int64_t*)far_keys, (const int64_t*)far_off,
        (unsigned long long*)far_counts, (int64_t*)close_keys,
        (unsigned long long*)close_count);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define LIST4_EXT_ENTRY(SUFFIX, T)                                          \
  extern "C" int list4_ext_##SUFFIX(                                        \
      const void* rows, long long r0, long long r1, const void* prefixes,  \
      const void* parents, const void* flags, const void* ntable,          \
      const void* tgt_row_of_box, const void* lsb, long long nlevels,      \
      const void* bbox_min, double root, double sof, long long d,          \
      void* far_counts, void* close_counts, const void* far_starts,        \
      void* far_lists, const void* close_starts, void* close_lists,        \
      long long fill, void* stream) {                                       \
    return boxtree_torch::list4_ext<T>(                                     \
        rows, r0, r1, prefixes, parents, flags, ntable, tgt_row_of_box,    \
        lsb, nlevels, bbox_min, root, sof, d, far_counts, close_counts,    \
        far_starts, far_lists, close_starts, close_lists, fill, stream);   \
  }
LIST4_EXT_ENTRY(f32, float)
LIST4_EXT_ENTRY(f64, double)

#define LIST3_EXT_ENTRY(SUFFIX, T)                                          \
  extern "C" int list3_ext_##SUFFIX(                                        \
      long long b0, long long b1, const void* prefixes,                    \
      const void* parents, const void* flags, const void* ntable,          \
      const void* tgt_row_of_box, const void* src_cumul,                   \
      const void* tbb_min, const void* tbb_max, const void* bbox_min,      \
      double root, double sof, const void* lsb, long long nlevels,         \
      long long d, long long crit, long long min_nsources,                 \
      void* far_keys, const void* far_off, void* far_counts,               \
      void* close_keys, void* close_count, void* stream) {                 \
    return boxtree_torch::list3_ext<T>(                                     \
        b0, b1, prefixes, parents, flags, ntable, tgt_row_of_box,          \
        src_cumul, tbb_min, tbb_max, bbox_min, root, sof, lsb, nlevels, d, \
        crit, min_nsources, far_keys, far_off, far_counts, close_keys,     \
        close_count, stream);                                               \
  }
LIST3_EXT_ENTRY(f32, float)
LIST3_EXT_ENTRY(f64, double)
