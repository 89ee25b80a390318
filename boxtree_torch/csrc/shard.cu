// K83-K88: the per-rank steps of the sharded tree build
// (boxtree_tpu/parallel/shard_sort.py and the tree half of
// boxtree_tpu/parallel/shard_build.py).  Each launch works on one rank's
// tensors; the collectives between ranks are copies made by the Python
// side (boxtree_torch/parallel/mesh.py).  Keys are int64, PAD = INT64_MAX
// marks an empty slot.
//
// K83 bucket_pack replaces the fixed-capacity send buffer of
// shard_sort.py:109-121 (sharded_key_sort, jit :136) and :317-324
// (sharded_permute's requests, jit :358): send[b, j] = local[start[b] + j]
// for j < len[b], else PAD, with each payload column (0 where empty; the
// permutation's slots get rank * per added), and the overflow flag
// (len[b] > cap) in the same launch.  One thread an output slot.
//
// K84 rebalance_place replaces the placement of shard_sort.py:211-232
// (sharded_rebalance, jit :242): a rank's equal shard from the <= 2 radius
// + 1 neighbour segments it receives.  The reference's per-offset
// dynamic_slice and select become one launch over a small header table,
// one row a segment: (source slot, destination slot, length, key pointer,
// payload pointers).  The segments' destinations are disjoint (the keys
// are in global order), so one thread an output slot finds its segment by
// a scan of the few rows and copies the key and payloads; a slot no
// segment reaches gets PAD / 0, as the reference's initial buffer.
//
// K85 permute_serve replaces the owner's side of sharded_permute
// (shard_sort.py:327-340): reply[t, :] = data[o_t - base, :] for a filled
// request slot t (0 for PAD), and inverse[o_t - base] = slot_t.  The
// requested originals of a permutation are distinct, so every inverse
// entry has one writer and no atomics are needed.  One thread a request.
//
// K86 permute_unpack replaces the requester's side (shard_sort.py:
// 342-350): out[j_sorted[t], :] = reply[b, t - start[b], :], b the bucket
// of position t (a binary search over the nranks + 1 starts).  j_sorted is
// a permutation, so every output row has one writer.  One thread a
// position.  K85 and K86 have entry points _f32 / _f64 (the coordinates).
//
// K87 shard_leaf_levels replaces the adaptive branch of sharded phase A
// (shard_build.py:296-333, sharded_leaf_levels, jit :379).  The reference
// runs a while loop of levels with an all_gather of boundary summaries and
// two psums in each; here the summaries of every level come first, in one
// pass (the Python side's leaf_summary: each rank's first and last key,
// its total weight, and at every level the weights of its first and last
// prefix runs), one all_gather gives them to every rank, and one launch a
// rank then walks each particle's levels as K43 does (tree.cu): the
// particle's level-l box is its key range in the shard, narrowed level by
// level by binary searches on prefixes, its weight the range's weight
// plus, where the range touches a shard boundary, the weight the other
// ranks hold of that box.  That halo comes from the gathered table: a box
// spanning shards a..b weighs tail(a) + whole shards between + head(b)
// (shard_build.py:53-152); each block forms its rank's halos of every
// level in shared memory first.  Without extents a box's weight does not
// depend on which particles are still active, which is what lets every
// level's summary be formed up front.  A particle starts a level-l box
// for l in (lcp, leaf], lcp taken against the left rank's last key for
// the first particle; the per-block level histogram (levels.cuh) adds
// these up.  Out: leaf levels, the rank's box starts a level and its
// particles unfit at depth, which the Python side sums over the ranks.
//
// K88 shard_box_skeleton replaces the level body of sharded phase B
// (shard_build.py:713-870, sharded_box_skeleton, jit :905) without the
// sources flag and extents.  One launch a rank a level, over the level's
// library cumsums (the inclusive count of box starts cs, the exclusive
// count of particles at or below the level ca) and the gathered per-rank
// rows of the level (skeleton_summary: starts, first prefix, first
// particle active, the particles continuing the box across the left
// boundary, how many first boxes have a parent on an earlier rank, their
// child digits).  At a box start i it writes the box's row: global id b0 +
// offset + k (offset the starts of earlier ranks), prefix, level, global
// start, count (ca up to the next start; the last box adds what the
// following shards continue, the chain of shard_build.py:762-795),
// parent (the level above's starts up to i, plus that level's offset) and
// the child link in the parent's row when the parent is this rank's.  A
// child whose parent starts on an earlier rank can only be one of that
// rank's first 2^d boxes, and its parent the box spanning the rank's left
// boundary: the first nranks * 2^d threads adopt those children whose
// parent row is this rank's, from the gathered rows, as the reference's
// shipped triples do (:844-866).
//
// Bound: bytes for K83-K86 (each value read and written once); memory
// latency for K87 (the dependent loads of its binary searches, as K43)
// and K88 (one search for the next start a box).
#include <climits>

#include "common.cuh"
#include "levels.cuh"

namespace boxtree_torch {
namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// {{{ K83

__global__ void bucket_pack_kernel(const int64_t* __restrict__ local,
                                   long long per,
                                   const int64_t* __restrict__ vals,
                                   int nvals,
                                   const int64_t* __restrict__ starts,
                                   int nb, long long cap, long long off,
                                   int64_t* __restrict__ send,
                                   int64_t* __restrict__ vsend,
                                   int* __restrict__ over) {
  const long long total = nb * cap;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int b = (int)(t / cap);
  const long long j = t - b * cap;
  const long long s0 = starts[b];
  const long long len = starts[b + 1] - s0;
  const bool valid = j < len;
  send[t] = valid ? local[s0 + j] : LLONG_MAX;
  for (int v = 0; v < nvals; ++v)
    vsend[v * total + t] = valid ? vals[v * per + s0 + j] + off : 0;
  if (j == 0 && len > cap) *over = 1;
}

// }}}

// {{{ K84

__global__ void rebalance_place_kernel(const long long* __restrict__ table,
                                       int nseg, int nvals, long long per,
                                       int64_t* __restrict__ out,
                                       int64_t* __restrict__ vout) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= per) return;
  const int width = 4 + nvals;
  for (int s = 0; s < nseg; ++s) {
    const long long* row = table + (long long)s * width;
    const long long dst = row[1];
    if (i >= dst && i < dst + row[2]) {
      const long long src = row[0] + (i - dst);
      out[i] = ((const int64_t*)row[3])[src];
      for (int v = 0; v < nvals; ++v)
        vout[v * per + i] = ((const int64_t*)row[4 + v])[src];
      return;
    }
  }
  out[i] = LLONG_MAX;
  for (int v = 0; v < nvals; ++v) vout[v * per + i] = 0;
}

// }}}

// {{{ K85 and K86

template <typename T>
__global__ void permute_serve_kernel(const int64_t* __restrict__ got_o,
                                     const int64_t* __restrict__ got_s,
                                     long long nreq,
                                     const T* __restrict__ data,
                                     long long per, int k, long long base,
                                     T* __restrict__ reply,
                                     int64_t* __restrict__ inv) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= nreq) return;
  const int64_t o = got_o[t];
  T* dst = reply + t * k;
  if (o == LLONG_MAX) {
    for (int c = 0; c < k; ++c) dst[c] = T(0);
    return;
  }
  long long loc = o - base;
  loc = loc < 0 ? 0 : (loc >= per ? per - 1 : loc);
  for (int c = 0; c < k; ++c) dst[c] = data[loc * k + c];
  inv[loc] = got_s[t];
}

template <typename T>
__global__ void permute_unpack_kernel(const T* __restrict__ reply, int nb,
                                      long long cap, int k,
                                      const int64_t* __restrict__ starts,
                                      const int64_t* __restrict__ j_sorted,
                                      long long per, T* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= per) return;
  // the bucket of position t: the starts after the first that are <= t
  int b = (int)upper_bound_in<int64_t>(starts + 1, 0, nb, t);
  if (b > nb - 1) b = nb - 1;
  long long lane = t - starts[b];
  lane = lane < 0 ? 0 : (lane >= cap ? cap - 1 : lane);
  const T* src = reply + ((long long)b * cap + lane) * k;
  T* dst = out + j_sorted[t] * k;
  for (int c = 0; c < k; ++c) dst[c] = src[c];
}

// }}}

// {{{ K87

__global__ void shard_leaf_levels_kernel(
    const int64_t* __restrict__ codes, long long per,
    const int64_t* __restrict__ cumw, const int64_t* __restrict__ summ,
    int nranks, int rank, long long max_w, int d, int depth,
    int* __restrict__ leaf, unsigned long long* __restrict__ packed) {
  __shared__ long long left[kMaxLevels], right[kMaxLevels];
  __shared__ int diff[kMaxLevels + 1];
  __shared__ unsigned long long unfit;
  const int ncol = depth + 1;
  const int width = 3 + 2 * ncol;
  // the weight other ranks hold of this rank's first and last box, every
  // level: the chains of shard_build.py:96-128
  for (int l = threadIdx.x; l < ncol; l += blockDim.x) {
    const int s = d * (depth - l);
    const int64_t* me = summ + (long long)rank * width;
    const int64_t p0 = me[0] >> s, p1 = me[1] >> s;
    long long a = 0, b = 0;
    for (int q = rank - 1; q >= 0; --q) {
      const int64_t* row = summ + (long long)q * width;
      if ((row[1] >> s) != p0) break;
      const bool single = (row[0] >> s) == p0;
      a += single ? row[2] : row[3 + ncol + l];
      if (!single) break;
    }
    for (int q = rank + 1; q < nranks; ++q) {
      const int64_t* row = summ + (long long)q * width;
      if ((row[0] >> s) != p1) break;
      const bool single = (row[1] >> s) == p1;
      b += single ? row[2] : row[3 + l];
      if (!single) break;
    }
    left[l] = a;
    right[l] = b;
  }
  LevelHistogram hist{diff};
  hist.clear();
  if (threadIdx.x == 0) unfit = 0;
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < per) {
    const int64_t code = codes[i];
    long long lo = 0, hi = per;
    int lf = -1;
    for (int l = 0; l <= depth; ++l) {
      if (l > 0) {
        // the keys of the particle's level-l prefix (d * depth <= 62, so
        // no shift overflows)
        const int64_t mask = (1ll << (d * (depth - l))) - 1;
        lo = lower_bound_in(codes, lo, i, code & ~mask);
        hi = upper_bound_in<int64_t>(codes, i + 1, hi, code | mask);
      }
      long long w = cumw ? cumw[hi] - cumw[lo] : hi - lo;
      if (lo == 0) w += left[l];
      if (hi == per) w += right[l];
      if (w <= max_w) {
        lf = l;
        break;
      }
    }
    if (lf < 0) {
      lf = depth;
      atomicAdd(&unfit, 1ull);
    }
    leaf[i] = lf;
    int lcp;
    if (i > 0)
      lcp = lcp_level(codes, i, d, depth);
    else if (rank > 0)
      lcp = lcp_of(summ[(long long)(rank - 1) * width + 1], code, d, depth);
    else
      lcp = -1;
    hist.add_range(lcp, lf);
  }
  __syncthreads();
  if (threadIdx.x == 0 && unfit) atomicAdd(&packed[depth + 2], unfit);
  hist.flush(packed, depth + 2);
}

// }}}

// {{{ K88

// the columns of a gathered skeleton_summary row (ops/shard.py)
constexpr int kNloc = 0, kPfx0 = 1, kFirstActive = 2, kHeads = 3,
              kRemote = 4, kDigits = 5;

__global__ void shard_box_skeleton_kernel(
    const int64_t* __restrict__ codes, long long per,
    const int* __restrict__ leaf, const int* __restrict__ thr,
    const int64_t* __restrict__ cs, const int64_t* __restrict__ ca,
    const int64_t* __restrict__ prev_cs, const int64_t* __restrict__ summ,
    const int64_t* __restrict__ prev_summ, int nranks,
    const int64_t* __restrict__ rowbase, int rank, int level, long long b0,
    long long prev_lstart, long long base, long long cap, int d, int depth,
    int64_t* __restrict__ box_id, int64_t* __restrict__ box_morton,
    int* __restrict__ box_level, int64_t* __restrict__ box_start,
    int64_t* __restrict__ box_cumul, int64_t* __restrict__ box_parent,
    int64_t* __restrict__ box_child) {
  const int nchild = 1 << d;
  const int width = kDigits + nchild;
  const int s = d * (depth - level);
  // this launch's scalars, from the gathered rows
  __shared__ long long offset, contribs, prev_offset, my_lo, my_hi;
  if (threadIdx.x == 0) {
    long long off = 0, poff = 0;
    for (int q = 0; q < rank; ++q) {
      off += summ[(long long)q * width + kNloc];
      poff += prev_summ[(long long)q * width + kNloc];
    }
    offset = off;
    prev_offset = poff;
    my_lo = prev_lstart + poff;
    my_hi = my_lo + prev_summ[(long long)rank * width + kNloc];
    // the following shards that continue my last box
    const int64_t p_last = codes[per - 1] >> s;
    long long c = 0;
    for (int q = rank + 1; q < nranks; ++q) {
      const int64_t* row = summ + (long long)q * width;
      if (!(row[kPfx0] == p_last && row[kFirstActive] == 1)) break;
      c += row[kHeads];
      if (row[kNloc] > 0) break;
    }
    contribs = c;
  }
  __syncthreads();
  const long long nmine = rowbase[level];
  const long long prev_rowbase = level > 0 ? rowbase[level - 1] : 0;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < per && leaf[t] >= level && thr[t] < level) {
    const long long k = cs[t] - 1;
    const bool last = k == summ[(long long)rank * width + kNloc] - 1;
    const long long nxt =
        last ? per : upper_bound_in<int64_t>(cs, t + 1, per, cs[t]);
    const long long gid = b0 + offset + k;
    const long long row = nmine + k;
    const int64_t p = codes[t] >> s;
    if (row < cap) {
      box_id[row] = gid;
      box_morton[row] = p;
      box_level[row] = level;
      box_start[row] = base + t;
      box_cumul[row] = ca[nxt] - ca[t] + (last ? contribs : 0);
    }
    if (level > 0) {
      const long long pc = prev_cs[t];
      if (row < cap) box_parent[row] = prev_lstart + prev_offset + pc - 1;
      const long long prow = prev_rowbase + pc - 1;
      if (pc >= 1 && prow < cap)
        box_child[prow * nchild + (p & (nchild - 1))] = gid;
    }
  }
  // children on later ranks of my box that spans their left boundary
  if (level > 0 && t < (long long)nranks * nchild) {
    const int q = (int)(t / nchild), j = (int)(t % nchild);
    const int64_t* row = summ + (long long)q * width;
    if (j < row[kRemote]) {
      long long off_q = 0, poff_q = 0;
      for (int r = 0; r < q; ++r) {
        off_q += summ[(long long)r * width + kNloc];
        poff_q += prev_summ[(long long)r * width + kNloc];
      }
      const long long par = prev_lstart + poff_q - 1;
      const long long prow = prev_rowbase + par - my_lo;
      if (par >= my_lo && par < my_hi && prow < cap)
        box_child[prow * nchild + row[kDigits + j]] = b0 + off_q + j;
    }
  }
}

// }}}

}  // namespace
}  // namespace boxtree_torch

extern "C" int bucket_pack(const void* local, long long per, const void* vals,
                           long long nvals, const void* starts, long long nb,
                           long long cap, long long val_offset, void* send,
                           void* vsend, void* over, void* stream) {
  using namespace boxtree_torch;
  const long long total = nb * cap;
  if (total > 0)
    bucket_pack_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)local, per, (const int64_t*)vals, (int)nvals,
        (const int64_t*)starts, (int)nb, cap, val_offset, (int64_t*)send,
        (int64_t*)vsend, (int*)over);
  return (int)cudaGetLastError();
}

extern "C" int rebalance_place(const void* table, long long nseg,
                               long long nvals, long long per, void* out,
                               void* vout, void* stream) {
  using namespace boxtree_torch;
  if (per > 0)
    rebalance_place_kernel<<<blocks_for(per), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const long long*)table, (int)nseg, (int)nvals, per,
        (int64_t*)out, (int64_t*)vout);
  return (int)cudaGetLastError();
}

#define PERMUTE_ENTRIES(SUFFIX, T)                                          \
  extern "C" int permute_serve_##SUFFIX(                                    \
      const void* got_o, const void* got_s, long long nreq,                 \
      const void* data, long long per, long long k, long long base,         \
      void* reply, void* inv, void* stream) {                               \
    using namespace boxtree_torch;                                          \
    if (nreq > 0)                                                           \
      permute_serve_kernel<T><<<blocks_for(nreq), kThreads, 0,              \
                                (cudaStream_t)stream>>>(                    \
          (const int64_t*)got_o, (const int64_t*)got_s, nreq,               \
          (const T*)data, per, (int)k, base, (T*)reply, (int64_t*)inv);     \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  extern "C" int permute_unpack_##SUFFIX(                                   \
      const void* reply, long long nb, long long cap, long long k,          \
      const void* starts, const void* j_sorted, long long per, void* out,   \
      void* stream) {                                                       \
    using namespace boxtree_torch;                                          \
    if (per > 0)                                                            \
      permute_unpack_kernel<T><<<blocks_for(per), kThreads, 0,              \
                                 (cudaStream_t)stream>>>(                   \
          (const T*)reply, (int)nb, cap, (int)k, (const int64_t*)starts,    \
          (const int64_t*)j_sorted, per, (T*)out);                          \
    return (int)cudaGetLastError();                                         \
  }
PERMUTE_ENTRIES(f32, float)
PERMUTE_ENTRIES(f64, double)

extern "C" int shard_leaf_levels(const void* codes, long long per,
                                 const void* cumw, long long has_w,
                                 const void* summ, long long nranks,
                                 long long rank, long long max_w, long long d,
                                 long long depth, void* leaf, void* packed,
                                 void* stream) {
  using namespace boxtree_torch;
  if (depth + 2 > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (per > 0)
    shard_leaf_levels_kernel<<<blocks_for(per), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int64_t*)codes, per, has_w ? (const int64_t*)cumw : nullptr,
        (const int64_t*)summ, (int)nranks, (int)rank, max_w, (int)d,
        (int)depth, (int*)leaf, (unsigned long long*)packed);
  return (int)cudaGetLastError();
}

extern "C" int shard_box_skeleton(
    const void* codes, long long per, const void* leaf, const void* thr,
    const void* cs, const void* ca, const void* prev_cs, const void* summ,
    const void* prev_summ, long long nranks, const void* rowbase,
    long long rank, long long level, long long b0, long long prev_lstart,
    long long base, long long cap, long long d, long long depth,
    void* box_id, void* box_morton, void* box_level, void* box_start,
    void* box_cumul, void* box_parent, void* box_child, void* stream) {
  using namespace boxtree_torch;
  const long long nthreads =
      per > nranks * (1ll << d) ? per : nranks * (1ll << d);
  if (per > 0)
    shard_box_skeleton_kernel<<<blocks_for(nthreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const int64_t*)codes, per, (const int*)leaf, (const int*)thr,
        (const int64_t*)cs, (const int64_t*)ca, (const int64_t*)prev_cs,
        (const int64_t*)summ, (const int64_t*)prev_summ, (int)nranks,
        (const int64_t*)rowbase, (int)rank, (int)level, b0, prev_lstart,
        base, cap, (int)d, (int)depth, (int64_t*)box_id,
        (int64_t*)box_morton, (int*)box_level, (int64_t*)box_start,
        (int64_t*)box_cumul, (int64_t*)box_parent, (int64_t*)box_child);
  return (int)cudaGetLastError();
}
