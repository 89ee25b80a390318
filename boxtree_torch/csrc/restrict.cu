// K5 restrict_demand: the demand pass of the 2:1 level restriction at one
// level m; K45 restrict_sweep: its consistency sweep at one level t.
//
// K5 replaces the demand pass of boxtree_tpu/tree/level_restrict.py:42
// _restrict_pass (lines 50-90).  The wrapper (boxtree_torch/ops/restrict.py)
// finishes with torch.cumsum of the marks and the covered update.
//
// Bound: memory latency.  Each level-m leaf box does 3^d pairs of binary
// searches over the n sorted keys (about 2 * 20 dependent loads each at
// 1e6 points); its own reads and writes are a few dozen bytes.  One thread
// per box: a first kernel lists the first particle of each run of level-m
// leaf particles in one cell (it stands for the run: every particle of a
// run demands the same ranges), a second takes the listed boxes, one a
// thread, so the searches of many boxes are in flight at once and the host
// never learns how many boxes there are.
//
// The result depends on order.  A demanded cell with no particles
// (lo == hi) raises the coarser leaf just before or at lo by one level;
// the reference applies these raises offset by offset, lo - 1 before lo,
// each step reading the leaf levels as the earlier steps left them.  So the
// marks kernel only collects them: it lists each such cell under its offset
// o, as its box's first particle and its range start lo (n slots an offset:
// a box has one such cell an offset at most, so a list cannot overflow).
// A second kernel of one block applies the lists in the reference's order,
// offset by offset, each step from a snapshot (every write of one step to
// one particle carries the same value, its snapshot level + 1), so a step
// costs that offset's cells and two barriers.
// A raise is possible only where, at the start of the level, the candidate
// is a leaf at level <= m - 2 containing the demanded cell (leaf levels only
// rise, and containment at a level implies it at every coarser one), so
// only those are collected: they are the rare 2:1 violations, and the
// single block stays cheap.
//
// K45 replaces the consistency sweep of _restrict_pass (lines 94-116) at
// one level t: a box splits as a whole, so within each maximal run of
// active particles (leaf >= t) with one level-t prefix, every particle with
// leaf == t rises to t + 1 if the run holds a deeper one.  The wrapper
// gives the runs' inclusive scan of their starts (a library cumsum), so a
// run's id is the scan at its particles; one kernel flags the runs with a
// deeper particle, a second raises, so that the flags see the leaf levels
// as they were before any raise.  One thread per particle, coalesced.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

__device__ __forceinline__ int pow3(int d) {
  return d == 1 ? 3 : (d == 2 ? 9 : 27);
}

// the candidate particle c lies in a leaf at level <= m - 2 whose box
// contains the level-(m-1) cell q
__device__ __forceinline__ bool raises(const int64_t* codes, long long n,
                                       const int* leaf, long long c,
                                       int64_t q, int d, int depth, int m,
                                       int* level) {
  if (c < 0 || c >= n) return false;
  const int t = leaf[c];
  *level = t;
  if (t > m - 2) return false;
  return (q >> (d * (m - 1 - t))) == (codes[c] >> (d * (depth - t)));
}

// the cell that offset o of the level-m cell `cells` demands, or false
// where the neighbour lies outside the root
__device__ __forceinline__ bool demanded_cell(const int64_t* cells, int o,
                                              int d, int m, int64_t* q) {
  int64_t nc[3];
  const int64_t nb = 1ll << m;
  int rest = o;
  for (int ax = d - 1; ax >= 0; --ax) {  // _offsets: axis 0 slowest
    nc[ax] = cells[ax] + (rest % 3) - 1;
    rest /= 3;
    if (nc[ax] < 0 || nc[ax] >= nb) return false;
  }
  for (int ax = 0; ax < d; ++ax) nc[ax] >>= 1;
  *q = interleave_cells(nc, d);
  return true;
}

// the first particle of each run of level-m leaf particles in one cell,
// appended to the list reps (counts[0] entries; warp-aggregated atomics)
__global__ void restrict_reps_kernel(const int64_t* __restrict__ codes,
                                     long long n,
                                     const int* __restrict__ leaf, int d,
                                     int depth, int m,
                                     int* __restrict__ counts,
                                     long long* __restrict__ reps) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  bool rep = false;
  if (r < n && leaf[r] == m) {
    const int shift = d * (depth - m);
    rep = r == 0 || leaf[r - 1] != m ||
          (codes[r - 1] >> shift) != (codes[r] >> shift);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, rep);
  if (!ballot) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&counts[0], __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (rep) reps[base + __popc(ballot & ((1u << lane) - 1))] = r;
}

// one thread per listed box (a grid-stride loop over counts[0]): its 3^d
// demanded cells' ranges marked; each cell with a raise candidate listed
// under its offset o (counts[1 + o] cells, from o n in ev_box and ev_lo)
__global__ void restrict_marks_kernel(
    const int64_t* __restrict__ codes, long long n,
    const int* __restrict__ leaf, int d, int depth, int m,
    int* __restrict__ marks, int* __restrict__ counts,
    const long long* __restrict__ reps, int* __restrict__ ev_box,
    int* __restrict__ ev_lo) {
  const int nrep = counts[0];
  const int shift = d * (depth - m);
  const int pshift = d * (depth - (m - 1));
  const int noffs = pow3(d);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < nrep; e += (long long)gridDim.x * blockDim.x) {
    const long long r = reps[e];
    int64_t cells[3];
    deinterleave_code(codes[r] >> shift, d, cells);
    for (int o = 0; o < noffs; ++o) {
      int64_t q;
      if (!demanded_cell(cells, o, d, m, &q)) continue;
      const long long lo = lower_bound_i64(codes, n, q << pshift);
      const long long hi = lower_bound_i64(codes, n, (q + 1) << pshift);
      atomicAdd(&marks[lo], 1);
      atomicAdd(&marks[hi], -1);
      int t;
      if (lo == hi && (raises(codes, n, leaf, lo - 1, q, d, depth, m, &t) ||
                       raises(codes, n, leaf, lo, q, d, depth, m, &t))) {
        const long long k = o * n + atomicAdd(&counts[1 + o], 1);
        ev_box[k] = (int)r;
        ev_lo[k] = (int)lo;
      }
    }
  }
}

__global__ void restrict_apply_kernel(
    const int64_t* __restrict__ codes, long long n, int* leaf, int d,
    int depth, int m, const int* __restrict__ counts,
    const int* __restrict__ ev_box, const int* __restrict__ ev_lo,
    int* ev_val) {
  const int noffs = pow3(d);
  const int shift = d * (depth - m);
  for (int o = 0; o < noffs; ++o) {
    const int cnt = counts[1 + o];
    const int* boxes = ev_box + (long long)o * n;
    const int* los = ev_lo + (long long)o * n;
    for (int which = -1; which <= 0; ++which) {  // lo - 1, then lo
      for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
        int64_t cells[3], q;
        deinterleave_code(codes[boxes[k]] >> shift, d, cells);
        demanded_cell(cells, o, d, m, &q);
        int t = 0;
        ev_val[k] = raises(codes, n, leaf, los[k] + which, q, d, depth, m, &t)
                        ? t + 1
                        : -1;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < cnt; k += blockDim.x)
        if (ev_val[k] >= 0) leaf[los[k] + which] = ev_val[k];
      __syncthreads();
    }
  }
}

__global__ void sweep_flag_kernel(const int* __restrict__ leaf, long long n,
                                  const int* __restrict__ seg, int t,
                                  int* __restrict__ flag) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n && leaf[i] > t) flag[seg[i] - 1] = 1;
}

__global__ void sweep_raise_kernel(int* __restrict__ leaf, long long n,
                                   const int* __restrict__ seg, int t,
                                   const int* __restrict__ flag) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n && leaf[i] == t && flag[seg[i] - 1]) leaf[i] = t + 1;
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int restrict_demand(const void* codes, long long n, void* leaf,
                               long long d, long long depth, long long m,
                               void* marks, void* counts, void* reps,
                               void* ev_box, void* ev_lo, void* ev_val,
                               void* stream) {
  using namespace boxtree_torch;
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    restrict_reps_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int64_t*)codes, n, (const int*)leaf, (int)d, (int)depth,
        (int)m, (int*)counts, (long long*)reps);
    // enough threads to fill the card; each takes boxes from the list
    restrict_marks_kernel<<<(unsigned)(blocks < 2048 ? blocks : 2048),
                            threads, 0, s>>>(
        (const int64_t*)codes, n, (const int*)leaf, (int)d, (int)depth,
        (int)m, (int*)marks, (int*)counts, (const long long*)reps,
        (int*)ev_box, (int*)ev_lo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    restrict_apply_kernel<<<1, 1024, 0, s>>>(
        (const int64_t*)codes, n, (int*)leaf, (int)d, (int)depth, (int)m,
        (const int*)counts, (const int*)ev_box, (const int*)ev_lo,
        (int*)ev_val);
  }
  return (int)cudaGetLastError();
}

extern "C" int restrict_sweep(void* leaf, long long n, const void* seg,
                              long long t, void* flag, void* stream) {
  using namespace boxtree_torch;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    sweep_flag_kernel<<<blocks, threads, 0, s>>>(
        (const int*)leaf, n, (const int*)seg, (int)t, (int*)flag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sweep_raise_kernel<<<blocks, threads, 0, s>>>(
        (int*)leaf, n, (const int*)seg, (int)t, (const int*)flag);
  }
  return (int)cudaGetLastError();
}
