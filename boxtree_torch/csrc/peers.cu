// K8 peer_lists: the peers of every box, as a count pass and a fill pass.
//
// Replaces boxtree_tpu/geometry/area_query.py:341 _peer_counts and :357
// _peer_fill (their candidate generator _gen_peers, :293-337).  The
// wrapper (boxtree_torch/ops/peers.py) turns the counts into starts with
// torch.cumsum between the two launches.
//
// Bound: memory latency.  A box at level l tries (l + 1) 3^d candidates,
// each a binary search over one level's Morton prefixes, and a coarser
// candidate that is not a leaf up to 2^d more searches for its children
// (the reference always does all of them; here they stop at the first
// child that touches).  The bytes that must move are a few per box.  One
// thread per box, so many boxes' searches are in flight at once.
//
// The fill pass writes each box's peers in the reference's candidate
// order (coarser level lp ascending, then offsets with axis 0 slowest), so
// the lists equal the reference's, order included.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

constexpr int kIsLeafBox = 1 << 4;

// the box at level l with the given cells, or -1 (_lookup)
__device__ __forceinline__ long long lookup(const int64_t* prefixes,
                                            const int64_t* lsb, int l,
                                            const int64_t* cells, int d) {
  const int64_t nb = 1ll << l;
  for (int ax = 0; ax < d; ++ax)
    if (cells[ax] < 0 || cells[ax] >= nb) return -1;
  const int64_t pfx = interleave_cells(cells, d);
  const long long nl = lsb[l + 1] - lsb[l];
  const long long idx = lower_bound_i64(prefixes + lsb[l], nl, pfx);
  if (idx >= nl || prefixes[lsb[l] + idx] != pfx) return -1;
  return lsb[l] + idx;
}

// closed boxes a (level la) and b (level lb >= la), non-negative cells,
// intersect (_touch)
__device__ __forceinline__ bool touch(const int64_t* a, int la,
                                      const int64_t* b, int lb, int d) {
  const int s = lb - la;
  for (int ax = 0; ax < d; ++ax) {
    const int64_t lo = a[ax] << s, hi = (a[ax] + 1) << s;
    if (!(lo <= b[ax] + 1 && b[ax] <= hi)) return false;
  }
  return true;
}

__global__ void peer_lists_kernel(const int64_t* __restrict__ prefixes,
                                  const int* __restrict__ flags,
                                  const int64_t* __restrict__ lsb,
                                  int nlevels, int d,
                                  int* __restrict__ counts,
                                  const int64_t* __restrict__ starts,
                                  int* __restrict__ lists, int fill) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= lsb[nlevels]) return;
  int level = 0;
  while (level + 1 < nlevels && lsb[level + 1] <= b) ++level;
  int64_t cells[3], cand[3], ccell[3];
  deinterleave_code(prefixes[b], d, cells);
  const int noffs = d == 1 ? 3 : (d == 2 ? 9 : 27);
  const int nchild = 1 << d;
  long long k = fill ? starts[b] : 0;
  for (int lp = 0; lp <= level; ++lp) {
    for (int o = 0; o < noffs; ++o) {
      int rest = o;
      for (int ax = d - 1; ax >= 0; --ax) {  // offsets: axis 0 slowest
        cand[ax] = (cells[ax] >> (level - lp)) + (rest % 3) - 1;
        rest /= 3;
      }
      const long long id = lookup(prefixes, lsb, lp, cand, d);
      if (id < 0 || !touch(cand, lp, cells, level, d)) continue;
      if (lp < level && !(flags[id] & kIsLeafBox)) {
        bool child_touches = false;
        for (int c = 0; c < nchild && !child_touches; ++c) {
          for (int ax = 0; ax < d; ++ax)
            ccell[ax] = 2 * cand[ax] + ((c >> (d - 1 - ax)) & 1);
          child_touches = lookup(prefixes, lsb, lp + 1, ccell, d) >= 0 &&
                          touch(ccell, lp + 1, cells, level, d);
        }
        if (child_touches) continue;
      }
      if (fill) lists[k] = (int)id;
      ++k;
    }
  }
  if (!fill) counts[b] = (int)k;
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int peer_lists(const void* prefixes, const void* flags,
                          const void* lsb, long long nlevels, long long d,
                          long long nboxes, void* counts, const void* starts,
                          void* lists, long long fill, void* stream) {
  using namespace boxtree_torch;
  if (nboxes > 0) {
    const int threads = 128;
    const long long blocks = (nboxes + threads - 1) / threads;
    peer_lists_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)prefixes, (const int*)flags, (const int64_t*)lsb,
        (int)nlevels, (int)d, (int*)counts, (const int64_t*)starts,
        (int*)lists, (int)fill);
  }
  return (int)cudaGetLastError();
}
