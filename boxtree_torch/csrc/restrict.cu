// K5 restrict_demand: the demand pass of the 2:1 level restriction at one
// level m.
//
// Replaces the demand pass of boxtree_tpu/tree/level_restrict.py:42
// _restrict_pass (lines 50-90).  The wrapper (boxtree_torch/ops/restrict.py)
// finishes with torch.cumsum of the marks and the covered update.
//
// Bound: memory latency.  Each level-m leaf box does 3^d pairs of binary
// searches over the n sorted keys (about 2 * 20 dependent loads each at
// 1e6 points); its own reads and writes are a few dozen bytes.  One thread
// per leaf box, so the searches of many boxes are in flight at once.
//
// The result depends on order.  A demanded cell with no particles
// (lo == hi) raises the coarser leaf just before or at lo by one level;
// the reference applies these raises offset by offset, lo - 1 before lo,
// each step reading the leaf levels as the earlier steps left them.  So the
// marks kernel only collects them, bucketed by offset, and a second kernel
// of one block applies the buckets in the reference's order, each step
// from a snapshot (every write of one step to one particle carries the same
// value, its snapshot level + 1).  A raise is possible only where, at the
// start of the level, the candidate is a leaf at level <= m - 2 containing
// the demanded cell (leaf levels only rise, and containment at a level
// implies it at every coarser one), so only those are collected: they are
// the rare 2:1 violations, and the single block stays cheap.
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

__global__ void restrict_marks_kernel(
    const int64_t* __restrict__ codes, long long n,
    const int64_t* __restrict__ reps, long long nrep,
    const int* __restrict__ leaf, int d, int depth, int m,
    int* __restrict__ marks, int* __restrict__ ev_count,
    int64_t* __restrict__ ev_q, int64_t* __restrict__ ev_lo) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= nrep) return;
  const int64_t code_m = codes[reps[r]] >> (d * (depth - m));
  int64_t cells[3], nc[3];
  deinterleave_code(code_m, d, cells);
  const int64_t nb = 1ll << m;
  const int pshift = d * (depth - (m - 1));
  const int noffs = pow3(d);
  for (int o = 0; o < noffs; ++o) {
    bool in_range = true;
    int rest = o;
    for (int ax = d - 1; ax >= 0; --ax) {  // _offsets: axis 0 slowest
      nc[ax] = cells[ax] + (rest % 3) - 1;
      rest /= 3;
      in_range = in_range && nc[ax] >= 0 && nc[ax] < nb;
    }
    if (!in_range) continue;
    for (int ax = 0; ax < d; ++ax) nc[ax] >>= 1;
    const int64_t q = interleave_cells(nc, d);
    const long long lo = lower_bound_i64(codes, n, q << pshift);
    const long long hi = lower_bound_i64(codes, n, (q + 1) << pshift);
    atomicAdd(&marks[lo], 1);
    atomicAdd(&marks[hi], -1);
    int t;
    if (lo == hi && (raises(codes, n, leaf, lo - 1, q, d, depth, m, &t) ||
                     raises(codes, n, leaf, lo, q, d, depth, m, &t))) {
      const int slot = atomicAdd(&ev_count[o], 1);
      ev_q[o * nrep + slot] = q;
      ev_lo[o * nrep + slot] = lo;
    }
  }
}

__global__ void restrict_apply_kernel(
    const int64_t* __restrict__ codes, long long n, long long nrep,
    int* leaf, int d, int depth, int m, const int* __restrict__ ev_count,
    const int64_t* __restrict__ ev_q, const int64_t* __restrict__ ev_lo,
    int* ev_val) {
  const int noffs = pow3(d);
  for (int o = 0; o < noffs; ++o) {
    const int cnt = ev_count[o];
    for (int which = -1; which <= 0; ++which) {  // lo - 1, then lo
      for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
        int t = 0;
        const bool up = raises(codes, n, leaf, ev_lo[o * nrep + e] + which,
                               ev_q[o * nrep + e], d, depth, m, &t);
        ev_val[e] = up ? t + 1 : -1;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < cnt; e += blockDim.x)
        if (ev_val[e] >= 0) leaf[ev_lo[o * nrep + e] + which] = ev_val[e];
      __syncthreads();
    }
  }
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int restrict_demand(const void* codes, long long n,
                               const void* reps, long long nrep, void* leaf,
                               long long d, long long depth, long long m,
                               void* marks, void* ev_count, void* ev_q,
                               void* ev_lo, void* ev_val, void* stream) {
  using namespace boxtree_torch;
  if (nrep > 0) {
    const int threads = 128;
    const long long blocks = (nrep + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    restrict_marks_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int64_t*)codes, n, (const int64_t*)reps, nrep,
        (const int*)leaf, (int)d, (int)depth, (int)m, (int*)marks,
        (int*)ev_count, (int64_t*)ev_q, (int64_t*)ev_lo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    restrict_apply_kernel<<<1, 1024, 0, s>>>(
        (const int64_t*)codes, n, nrep, (int*)leaf, (int)d, (int)depth,
        (int)m, (const int*)ev_count, (const int64_t*)ev_q,
        (const int64_t*)ev_lo, (int*)ev_val);
  }
  return (int)cudaGetLastError();
}
