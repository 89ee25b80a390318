// K24 neighbor_table, K25 row_lists_sl_l2, K26 lists_43 and K27 list1:
// the well_sep_is_n_away == 1 traversal (boxtree_tpu/traversal/
// neighbors.py and boxtree_tpu/traversal/build.py, table mode).
//
// K24 replaces boxtree_tpu/traversal/neighbors.py:65 build_neighbor_table:
// the clamped (nboxes, 3^d) table, entry = the deepest existing box that
// covers cell(b) + offset j, bit 29 IS_SOURCE_BOX, bit 30 "is a target
// box", -1 outside the domain.  One launch per level, one thread per
// (box, column): the child's entry is the parent's entry in column
// pcol(q, j) or, where that entry lies at the parent level and has a child
// with digit cdig(q, j), that child.
//
// K25 replaces the colleague and List-2 halves of build.py:942
// _rowlists_emit_pass (:636 _emit_rowcsr, :736 _emit_l2_parent_rowcsr,
// :899 _emit_row_prune); K26 its List-4 half and the List-3 half of :1151
// _edge_emit_pass without target extents; K27 the List-1 half of
// _edge_emit_pass, target side and source side, the latter by a binary
// search in each coarser level's Morton prefixes when targets have
// extents (build.py:342 _gen_list1_source_side).  The plain versions are
// the generators of boxtree_torch/traversal/neighbors.py, run by
// boxtree_torch/ops/traversal.py; both must give the same lists, entry
// for entry.
//
// K25-K27: one warp per row.  Each round of 32 lanes tests 32 candidates
// (the table row's columns, or for List 2 the children of the parent's
// columns); the valid ones are compacted into shared memory by ballot, in
// candidate order.  The count pass writes the row's count; after
// torch.cumsum the fill pass writes the row at its start: CSR rows
// (colleagues, Lists 2 and 4) ranked in ascending order (a value's rank is
// the number of smaller values, ties broken by candidate order, so the row
// equals a sort of the candidates), edge keys (Lists 1 and 3) as found,
// since the wrapper sorts them with torch.sort.
//
// Bound: memory latency.  Every row reads its own table row, or its
// parent's, and a few box arrays at scattered places; the bytes that must
// move are those reads plus the lists written.  A warp per row keeps 32
// lanes' reads of one row in flight, and many rows' at once.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

constexpr int kIsSourceBox = 1 << 0;
constexpr int kHasSourceChildBoxes = 1 << 2;
constexpr int kIdMask = (1 << 29) - 1;
constexpr int kSrcBit = 1 << 29;
constexpr int kTgtBit = 1 << 30;
constexpr int kWarps = 4;  // warps (rows) per block
constexpr int kMaxCand = 216;  // 27 columns x 8 children (List 2, 3D)

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

__device__ __forceinline__ int entry_of(long long x, const int* flags,
                                        const uint8_t* tgt_mask) {
  return (int)x | ((flags[x] & kIsSourceBox) ? kSrcBit : 0) |
         (tgt_mask[x] ? kTgtBit : 0);
}

__device__ __forceinline__ bool has_bit(int t, int bit) {
  return t >= 0 && (t & bit) != 0;
}

// _canonical_mask: lane j keeps a clamped coarser entry (level lev_e) in
// exactly one column of a row at level row_level
template <int D>
__device__ __forceinline__ bool canonical(const int64_t* cells, int lev_e,
                                          int row_level, int j) {
  const int s = max(row_level - lev_e, 0);
  for (int ax = 0; ax < D; ++ax) {
    const int o = offset_of<D>(j, ax);
    if (o != 0 && ((cells[ax] + o) >> s) == (cells[ax] >> s)) return false;
  }
  return true;
}

// _not_touching: column j's entry (level lev_e) of the anchor's row does
// not touch the fine box (cells_f, level_f)
template <int D>
__device__ __forceinline__ bool not_touching(const int64_t* cells_f,
                                             int level_f,
                                             const int64_t* anchor,
                                             int anchor_level, int lev_e,
                                             int j) {
  const int s = max(anchor_level - lev_e, 0);
  const int t = s + (level_f - anchor_level);
  for (int ax = 0; ax < D; ++ax) {
    const int64_t q = (anchor[ax] + offset_of<D>(j, ax)) >> s;
    const int64_t lo = q * ((int64_t)1 << t);
    const int64_t hi = (q + 1) * ((int64_t)1 << t);
    if (!(lo <= cells_f[ax] + 1 && cells_f[ax] <= hi)) return true;
  }
  return false;
}

// one round of a warp's candidates: the valid ones go to buf[n..] in lane
// order; returns the new count (the same on every lane)
template <typename V, typename U>
__device__ __forceinline__ int append(bool valid, U v, V* buf, int n) {
  const unsigned mask = __ballot_sync(0xffffffffu, valid);
  const int lane = threadIdx.x & 31;
  if (valid) buf[n + __popc(mask & ((1u << lane) - 1))] = (V)v;
  return n + __popc(mask);
}

// the count pass writes n; the fill pass writes buf[0..n) at out + start
// ascending (sorted) or as found
template <typename V>
__device__ __forceinline__ void finish_row(const V* buf, int n, bool sorted,
                                           int fill, int* counts,
                                           long long row, V* out,
                                           const int64_t* starts) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  if (!fill) {
    if (lane == 0) counts[row] = n;
    return;
  }
  V* dst = out + starts[row];
  for (int i = lane; i < n; i += 32) {
    const V v = buf[i];
    int rank = i;
    if (sorted) {
      rank = 0;
      for (int k = 0; k < n; ++k) {
        const V u = buf[k];
        rank += (u < v) || (u == v && k < i);
      }
    }
    dst[rank] = v;
  }
}

// {{{ K24

template <int D>
__global__ void neighbor_table_kernel(
    const int64_t* __restrict__ prefixes, const int* __restrict__ parents,
    const int* __restrict__ child_rows, const int* __restrict__ flags,
    const uint8_t* __restrict__ tgt_mask, int* __restrict__ table,
    long long b0, long long b1, long long p0) {
  constexpr int M = D == 2 ? 9 : 27;
  constexpr int NC = 1 << D;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (b1 - b0) * M) return;
  const long long b = b0 + i / M;
  const int j = (int)(i % M);
  if (b == 0) {
    table[j] = j == M / 2 ? entry_of(0, flags, tgt_mask) : -1;
    return;
  }
  const int q = (int)(prefixes[b] & (NC - 1));
  int pcol = 0, cdig = 0;
  for (int ax = 0; ax < D; ++ax) {
    const int s = ((q >> (D - 1 - ax)) & 1) + offset_of<D>(j, ax);
    pcol = pcol * 3 + (s >> 1) + 1;
    cdig |= (s & 1) << (D - 1 - ax);
  }
  const int pn = table[(long long)parents[b] * M + pcol];
  int out = pn;
  if (pn >= 0 && (pn & kIdMask) >= p0) {
    const int c = child_rows[(long long)(pn & kIdMask) * NC + cdig];
    if (c > 0) out = entry_of(c, flags, tgt_mask);
  }
  table[b * M + j] = out;
}

// }}}

// {{{ K25: colleagues (rows = all boxes), List 2 (rows = totp boxes)

template <int D>
__global__ void row_lists_sl_l2_kernel(
    const int* __restrict__ ntable, const int* __restrict__ parents,
    const int64_t* __restrict__ prefixes, const int* __restrict__ child_rows,
    const int* __restrict__ totp_boxes, const int64_t* __restrict__ lsb,
    long long nboxes, long long ntotp, int nlevels,
    int* __restrict__ sl_counts, int* __restrict__ l2_counts,
    const int64_t* __restrict__ sl_starts,
    const int64_t* __restrict__ l2_starts, int* __restrict__ sl_lists,
    int* __restrict__ l2_lists, int fill) {
  constexpr int M = D == 2 ? 9 : 27;
  constexpr int NC = 1 << D;
  __shared__ int smem[kWarps][kMaxCand];
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.x * (long long)kWarps + threadIdx.x / 32;
  if (w >= nboxes + ntotp) return;
  int* buf = smem[threadIdx.x / 32];
  int n = 0;
  if (w < nboxes) {
    // fgen_slnws: the same-level entries, centre column left out
    const int lev = level_of(w, lsb, nlevels);
    const int t = lane < M ? ntable[w * M + lane] : -1;
    const bool valid =
        lane != M / 2 && t >= 0 && (t & kIdMask) >= lsb[lev];
    n = append(valid, t & kIdMask, buf, 0);
    finish_row(buf, n, true, fill, sl_counts, w, sl_lists, sl_starts);
    return;
  }
  // fgen_list2: the children of the parent's colleagues that are well
  // separated from the row box
  const long long r = w - nboxes;
  const int b = totp_boxes[r];
  const int lev = level_of(b, lsb, nlevels);
  if (lev > 0) {
    const int* prow = ntable + (long long)parents[b] * M;
    const int digit = (int)(prefixes[b] & (NC - 1));
    const int64_t min_id = lsb[lev - 1];
    for (int k0 = 0; k0 < M * NC; k0 += 32) {
      const int k = k0 + lane;
      bool valid = false;
      int v = 0;
      if (k < M * NC) {
        const int j = k / NC, q = k % NC;
        bool sep = false;
        for (int ax = 0; ax < D; ++ax) {
          const int diff = 2 * offset_of<D>(j, ax) +
                           ((q >> (D - 1 - ax)) & 1) -
                           ((digit >> (D - 1 - ax)) & 1);
          sep |= diff > 1 || diff < -1;
        }
        if (sep) {
          const int pn = prow[j];
          if (pn >= 0 && (pn & kIdMask) >= min_id) {
            v = child_rows[(long long)(pn & kIdMask) * NC + q];
            valid = v > 0;
          }
        }
      }
      n = append(valid, v, buf, n);
    }
  }
  finish_row(buf, n, true, fill, l2_counts, r, l2_lists, l2_starts);
}

// }}}

// {{{ K26: List 4 (rows = totp boxes), List-3 keys (rows = all boxes)

template <int D>
__global__ void lists_43_kernel(
    const int* __restrict__ ntable, const int* __restrict__ parents,
    const int64_t* __restrict__ prefixes, const int* __restrict__ flags,
    const int* __restrict__ totp_boxes, const int64_t* __restrict__ lsb,
    long long ntotp, long long nboxes, int nlevels,
    int* __restrict__ l4_counts, int* __restrict__ l3_counts,
    const int64_t* __restrict__ l4_starts,
    const int64_t* __restrict__ l3_starts, int* __restrict__ l4_lists,
    int64_t* __restrict__ l3_keys, int fill) {
  constexpr int M = D == 2 ? 9 : 27;
  __shared__ int ids[kWarps][32];
  __shared__ int64_t keys[kWarps][32];
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.x * (long long)kWarps + threadIdx.x / 32;
  if (w >= ntotp + nboxes) return;
  const bool l4 = w < ntotp;
  const long long row = l4 ? w : w - ntotp;
  const long long b = l4 ? totp_boxes[w] : row;
  const int lb = level_of(b, lsb, nlevels);
  // fgen_list4 / fgen_list3: coarser leaves (sources for List 4, targets
  // for List 3) in the parent's row that touch the parent but not b
  const bool gate =
      lb > 0 && (l4 || (flags[b] & (kIsSourceBox | kHasSourceChildBoxes)));
  bool valid = false;
  int id = 0;
  if (gate && lane < M) {
    int64_t cells[D], pcells[D];
    deinterleave_code(prefixes[b], D, cells);
    for (int ax = 0; ax < D; ++ax) pcells[ax] = cells[ax] >> 1;
    const int t = ntable[(long long)parents[b] * M + lane];
    id = t & kIdMask;
    if (has_bit(t, l4 ? kSrcBit : kTgtBit)) {
      const int lev_e = level_of(id, lsb, nlevels);
      valid = canonical<D>(pcells, lev_e, lb - 1, lane) &&
              not_touching<D>(cells, lb, pcells, lb - 1, lev_e, lane);
    }
  }
  if (l4) {
    int* buf = ids[threadIdx.x / 32];
    const int n = append(valid, id, buf, 0);
    finish_row(buf, n, true, fill, l4_counts, row, l4_lists, l4_starts);
  } else {
    int64_t* buf = keys[threadIdx.x / 32];
    const int n = append(valid, ((int64_t)id << 32) | b, buf, 0);
    finish_row(buf, n, false, fill, l3_counts, row, l3_keys, l3_starts);
  }
}

// }}}

// {{{ K27: List-1 keys, target side (rows = target boxes) and source side
// (rows = source-or-target boxes)

template <int D>
__global__ void list1_kernel(
    const int* __restrict__ ntable, const int64_t* __restrict__ prefixes,
    const int* __restrict__ flags, const int* __restrict__ target_boxes,
    const int* __restrict__ part_boxes,
    const int64_t* __restrict__ tgt_row_of_box,
    const int64_t* __restrict__ lsb, long long ntgt, long long npart,
    int nlevels, int ext, int* __restrict__ counts,
    const int64_t* __restrict__ starts, int64_t* __restrict__ keys,
    int fill) {
  constexpr int M = D == 2 ? 9 : 27;
  // a source row with extents emits up to M per coarser level
  extern __shared__ int64_t dyn[];
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.x * (long long)kWarps + threadIdx.x / 32;
  if (w >= ntgt + npart) return;
  int64_t* buf = dyn + (threadIdx.x / 32) * (long long)M * (nlevels + 1);
  int n = 0;
  if (w < ntgt) {
    // fgen_list1_tgt: the source leaves of the row at its level or coarser
    const int b = target_boxes[w];
    const int lt = level_of(b, lsb, nlevels);
    const int* row = ntable + (long long)b * M;
    const bool row_is_tgt = has_bit(row[M / 2], kTgtBit);
    int64_t cells[D];
    deinterleave_code(prefixes[b], D, cells);
    const int t = lane < M ? row[lane] : -1;
    const int id = t & kIdMask;
    bool valid = false;
    if (row_is_tgt && has_bit(t, kSrcBit))
      valid = canonical<D>(cells, level_of(id, lsb, nlevels), lt, lane);
    n = append(valid, (tgt_row_of_box[b] << 32) | id, buf, 0);
    finish_row(buf, n, false, fill, counts, w, keys, starts);
    return;
  }
  // the source side: the coarser target boxes touching source leaf b
  const int b = part_boxes[w - ntgt];
  const int ls = level_of(b, lsb, nlevels);
  int64_t cells[D];
  deinterleave_code(prefixes[b], D, cells);
  if (!ext) {
    // fgen_list1_src: the coarser target leaves in b's own row
    const int* row = ntable + (long long)b * M;
    const bool row_is_src = has_bit(row[M / 2], kSrcBit);
    const int t = lane < M ? row[lane] : -1;
    const int id = t & kIdMask;
    bool valid = false;
    if (row_is_src && has_bit(t, kTgtBit) && id < lsb[ls])
      valid = canonical<D>(cells, level_of(id, lsb, nlevels), ls, lane);
    n = append(valid, valid ? (tgt_row_of_box[id] << 32) | b : 0, buf, 0);
  } else if (flags[b] & kIsSourceBox) {
    // _gen_list1_source_side: at each coarser level, the boxes at the
    // neighbouring cells of b's ancestor, found by binary search
    for (int lt = 0; lt < ls; ++lt) {
      bool valid = false;
      int64_t key = 0;
      if (lane < M) {
        int64_t cand[D];
        bool in_range = true, touch = true;
        const int s = ls - lt;
        for (int ax = 0; ax < D; ++ax) {
          cand[ax] = (cells[ax] >> s) + offset_of<D>(lane, ax);
          in_range &= cand[ax] >= 0 && cand[ax] < ((int64_t)1 << lt);
          const int64_t lo = cand[ax] * ((int64_t)1 << s);
          const int64_t hi = (cand[ax] + 1) * ((int64_t)1 << s);
          touch &= lo <= cells[ax] + 1 && cells[ax] <= hi;
        }
        if (in_range && touch) {
          const int64_t pfx = interleave_cells(cand, D);
          const long long n_l = lsb[lt + 1] - lsb[lt];
          const long long idx = lower_bound_i64(prefixes + lsb[lt], n_l, pfx);
          if (idx < n_l && prefixes[lsb[lt] + idx] == pfx) {
            const int64_t trow = tgt_row_of_box[lsb[lt] + idx];
            valid = trow >= 0;
            key = (trow << 32) | b;
          }
        }
      }
      n = append(valid, key, buf, n);
    }
  }
  finish_row(buf, n, false, fill, counts, w, keys, starts);
}

// }}}

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n, long long per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

int neighbor_table(const void* prefixes, const void* parents,
                   const void* child_rows, const void* flags,
                   const void* tgt_mask, void* table, long long b0,
                   long long b1, long long p0, long long d, void* stream) {
  const long long n = (b1 - b0) * (d == 2 ? 9 : 27);
  if (n > 0) {
    auto kernel =
        d == 2 ? neighbor_table_kernel<2> : neighbor_table_kernel<3>;
    kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)prefixes, (const int*)parents,
        (const int*)child_rows, (const int*)flags, (const uint8_t*)tgt_mask,
        (int*)table, b0, b1, p0);
  }
  return (int)cudaGetLastError();
}

int row_lists_sl_l2(const void* ntable, const void* parents,
                    const void* prefixes, const void* child_rows,
                    const void* totp_boxes, const void* lsb,
                    long long nboxes, long long ntotp, long long nlevels,
                    long long d, void* sl_counts, void* l2_counts,
                    const void* sl_starts, const void* l2_starts,
                    void* sl_lists, void* l2_lists, long long fill,
                    void* stream) {
  const long long rows = nboxes + ntotp;
  if (rows > 0) {
    auto kernel =
        d == 2 ? row_lists_sl_l2_kernel<2> : row_lists_sl_l2_kernel<3>;
    kernel<<<blocks_for(rows, kWarps), kWarps * 32, 0,
             (cudaStream_t)stream>>>(
        (const int*)ntable, (const int*)parents, (const int64_t*)prefixes,
        (const int*)child_rows, (const int*)totp_boxes, (const int64_t*)lsb,
        nboxes, ntotp, (int)nlevels, (int*)sl_counts, (int*)l2_counts,
        (const int64_t*)sl_starts, (const int64_t*)l2_starts,
        (int*)sl_lists, (int*)l2_lists, (int)fill);
  }
  return (int)cudaGetLastError();
}

int lists_43(const void* ntable, const void* parents, const void* prefixes,
             const void* flags, const void* totp_boxes, const void* lsb,
             long long ntotp, long long nboxes, long long nlevels,
             long long d, void* l4_counts, void* l3_counts,
             const void* l4_starts, const void* l3_starts, void* l4_lists,
             void* l3_keys, long long fill, void* stream) {
  const long long rows = ntotp + nboxes;
  if (rows > 0) {
    auto kernel = d == 2 ? lists_43_kernel<2> : lists_43_kernel<3>;
    kernel<<<blocks_for(rows, kWarps), kWarps * 32, 0,
             (cudaStream_t)stream>>>(
        (const int*)ntable, (const int*)parents, (const int64_t*)prefixes,
        (const int*)flags, (const int*)totp_boxes, (const int64_t*)lsb,
        ntotp, nboxes, (int)nlevels, (int*)l4_counts, (int*)l3_counts,
        (const int64_t*)l4_starts, (const int64_t*)l3_starts,
        (int*)l4_lists, (int64_t*)l3_keys, (int)fill);
  }
  return (int)cudaGetLastError();
}

int list1(const void* ntable, const void* prefixes, const void* flags,
          const void* target_boxes, const void* part_boxes,
          const void* tgt_row_of_box, const void* lsb, long long ntgt,
          long long npart, long long nlevels, long long d, long long ext,
          void* counts, const void* starts, void* keys, long long fill,
          void* stream) {
  const long long rows = ntgt + npart;
  if (rows > 0) {
    const int m = d == 2 ? 9 : 27;
    // at most 9 x 33 or 27 x 22 keys a row (2D and 3D Morton depths):
    // under 48 KiB a block
    const size_t smem = sizeof(int64_t) * kWarps * m * (nlevels + 1);
    auto kernel = d == 2 ? list1_kernel<2> : list1_kernel<3>;
    kernel<<<blocks_for(rows, kWarps), kWarps * 32, smem,
             (cudaStream_t)stream>>>(
        (const int*)ntable, (const int64_t*)prefixes, (const int*)flags,
        (const int*)target_boxes, (const int*)part_boxes,
        (const int64_t*)tgt_row_of_box, (const int64_t*)lsb, ntgt, npart,
        (int)nlevels, (int)ext, (int*)counts, (const int64_t*)starts,
        (int64_t*)keys, (int)fill);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int neighbor_table(const void* prefixes, const void* parents,
                              const void* child_rows, const void* flags,
                              const void* tgt_mask, void* table,
                              long long b0, long long b1, long long p0,
                              long long d, void* stream) {
  return boxtree_torch::neighbor_table(prefixes, parents, child_rows, flags,
                                       tgt_mask, table, b0, b1, p0, d,
                                       stream);
}

extern "C" int row_lists_sl_l2(
    const void* ntable, const void* parents, const void* prefixes,
    const void* child_rows, const void* totp_boxes, const void* lsb,
    long long nboxes, long long ntotp, long long nlevels, long long d,
    void* sl_counts, void* l2_counts, const void* sl_starts,
    const void* l2_starts, void* sl_lists, void* l2_lists, long long fill,
    void* stream) {
  return boxtree_torch::row_lists_sl_l2(
      ntable, parents, prefixes, child_rows, totp_boxes, lsb, nboxes, ntotp,
      nlevels, d, sl_counts, l2_counts, sl_starts, l2_starts, sl_lists,
      l2_lists, fill, stream);
}

extern "C" int lists_43(const void* ntable, const void* parents,
                        const void* prefixes, const void* flags,
                        const void* totp_boxes, const void* lsb,
                        long long ntotp, long long nboxes, long long nlevels,
                        long long d, void* l4_counts, void* l3_counts,
                        const void* l4_starts, const void* l3_starts,
                        void* l4_lists, void* l3_keys, long long fill,
                        void* stream) {
  return boxtree_torch::lists_43(ntable, parents, prefixes, flags,
                                 totp_boxes, lsb, ntotp, nboxes, nlevels, d,
                                 l4_counts, l3_counts, l4_starts, l3_starts,
                                 l4_lists, l3_keys, fill, stream);
}

extern "C" int list1(const void* ntable, const void* prefixes,
                     const void* flags, const void* target_boxes,
                     const void* part_boxes, const void* tgt_row_of_box,
                     const void* lsb, long long ntgt, long long npart,
                     long long nlevels, long long d, long long ext,
                     void* counts, const void* starts, void* keys,
                     long long fill, void* stream) {
  return boxtree_torch::list1(ntable, prefixes, flags, target_boxes,
                              part_boxes, tgt_row_of_box, lsb, ntgt, npart,
                              nlevels, d, ext, counts, starts, keys, fill,
                              stream);
}
