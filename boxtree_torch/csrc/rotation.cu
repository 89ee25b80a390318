// The rotation ("point-and-shoot") M2L of the 3D Laplace wranglers and the
// classification of List 2's edges it runs on.
//
// K75 m2l_classify_keys: per List-2 edge e, its CSR row (a binary search
// of the row starts), the target box target_or_target_parent_boxes[row]
// and the source box lists[e]; both boxes' cells from their Morton
// prefixes, the translation class of cell(tgt) - cell(src) in the window
// table (-1 outside), and the packed key
//   ((level(tgt) * nclasses + class) << bits) | e
// with npossible = nlevels * nclasses in place of the operator key for an
// edge outside the window.  K76 m2l_classify_unpack: per sorted key, the
// edge's target and source boxes (int32, in key order) and the histogram
// of the npossible + 1 operator keys (warp-aggregated integer atomics: the
// keys are sorted, so a warp adds one count for each run it holds).
// Between the two, torch.sort of the keys stands for the reference's
// lax.sort.  Together they replace boxtree_tpu/models/particle_blocks.py:
// 214 M2LPlan._classify_dev.  Bound: bytes (the CSR, the boxes' prefixes
// and levels read, the keys written and read back, the boxes and the
// histogram written); integers, so the results equal the twin's exactly.
//
// K77-K79 m2l_rotate (_c128, _f64, _f32): for the edges of one operator
// (level, class) at a time, in tiles of up to T edges,
//   local[tgt] += ((mpole[src] W_S^-1) Tax) conj(W_A)
// as row vectors: rotate per degree n by the (2n+1)^2 block of the edge's
// rotation class, translate along z by the operator's axial blocks (one
// (p+1-|m|)^2 block per m, from (n', -m) to (n, m)), unrotate per degree.
// Replaces boxtree_tpu/models/rotation_m2l.py:221 RotationM2L.apply, as
// expansion_base.py:1135 multipole_to_local_edges drives it (the gather
// of the source rows and the scatter into the targets).  Complex128 rows
// are interleaved (re, im); the real-pair rows are [re | im] halves, the
// arithmetic complex on them in the row's precision.
//
// Bound: operations, about 4 sum_n (2n+1)^2 + 2 sum_m (p+1-|m|)^2 complex
// multiply-adds an edge (9.7k real ones at order 8), over the gathered
// rows.  One CTA a tile: it gathers its tile's multipole rows into shared
// memory once, runs the three stages there (two buffers, the blocks read
// from global memory, where a warp's threads read neighbouring entries of
// one row of a block), and adds each output coefficient into the target's
// local row with atomicAdd, so no (edges, K) array is made in device
// memory.  The order of the additions into a local row depends on the
// schedule, so the sums differ from the twin's by rounding.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

constexpr int kThreads = 256;

// largest row r of the CSR starts[0..nrows] with starts[r] <= e
__device__ __forceinline__ long long csr_row(const int* starts,
                                             long long nrows, long long e) {
  long long lo = 0, hi = nrows - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if ((long long)starts[mid] <= e)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void classify_keys_kernel(
    const int64_t* __restrict__ prefixes, const int* __restrict__ levels,
    const int* __restrict__ starts, const int* __restrict__ lists,
    const int* __restrict__ totp, const int64_t* __restrict__ table,
    long long nedges, long long nrows, int d, int radius,
    long long nclasses, long long npossible, int bits,
    int64_t* __restrict__ keys) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nedges) return;
  const int tgt = totp[csr_row(starts, nrows, e)];
  const int src = lists[e];
  int64_t ct[3], cs[3];
  deinterleave_code(prefixes[tgt], d, ct);
  deinterleave_code(prefixes[src], d, cs);
  const int width = 2 * radius + 1;
  long long idx = 0, w = 1;
  bool in_range = true;
  for (int a = 0; a < d; ++a) {
    const long long v = ct[a] - cs[a] + radius;
    in_range = in_range && v >= 0 && v < width;
    idx += v * w;
    w *= width;
  }
  const int64_t cls = in_range ? table[idx] : -1;
  const int64_t opkey =
      cls >= 0 ? (int64_t)levels[tgt] * nclasses + cls : npossible;
  keys[e] = (opkey << bits) | e;
}

__global__ void classify_unpack_kernel(
    const int64_t* __restrict__ keys, const int* __restrict__ starts,
    const int* __restrict__ lists, const int* __restrict__ totp,
    long long nedges, long long nrows, int bits, int* __restrict__ tgt,
    int* __restrict__ src, unsigned long long* __restrict__ hist) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nedges) return;
  const int64_t key = keys[i];
  const long long e = key & ((1ll << bits) - 1);
  const long long okey = key >> bits;
  tgt[i] = totp[csr_row(starts, nrows, e)];
  src[i] = lists[e];
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, (unsigned long long)okey);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(peers) - 1)
    atomicAdd(hist + okey, (unsigned long long)__popc(peers));
}

// {{{ K77-K79

template <typename R>
struct Cplx;
template <>
struct Cplx<float> {
  using T = float2;
};
template <>
struct Cplx<double> {
  using T = double2;
};

// complex128 rows: interleaved (re, im)
struct InterleavedRows {
  using Real = double;
  __device__ static double2 load(const double* rows, long long row, int K,
                                 int j) {
    return reinterpret_cast<const double2*>(rows)[row * K + j];
  }
  __device__ static void add(double* rows, long long row, int K, int j,
                             double2 v) {
    atomicAdd(rows + 2 * (row * K + j), v.x);
    atomicAdd(rows + 2 * (row * K + j) + 1, v.y);
  }
};

// real-pair rows: [re | im] halves of K values each
template <typename R>
struct PairRows {
  using Real = R;
  using C = typename Cplx<R>::T;
  __device__ static C load(const R* rows, long long row, int K, int j) {
    C v;
    v.x = rows[row * 2 * K + j];
    v.y = rows[row * 2 * K + K + j];
    return v;
  }
  __device__ static void add(R* rows, long long row, int K, int j, C v) {
    atomicAdd(rows + row * 2 * K + j, v.x);
    atomicAdd(rows + row * 2 * K + K + j, v.y);
  }
};

template <typename C>
__device__ __forceinline__ void cmac(C& acc, C a, C b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

__device__ __forceinline__ int degree_of(int j) {
  int n = (int)sqrtf((float)j);
  while (n * n > j) --n;
  while ((n + 1) * (n + 1) <= j) ++n;
  return n;
}

// sum_{n' < n} (2n'+1)^2: where degree n's rotation block starts
__device__ __forceinline__ int rot_offset(int n) {
  return n * (2 * n - 1) * (2 * n + 1) / 3;
}

// sum_{a=1}^{x} a^2
__device__ __forceinline__ int sum_sq(int x) {
  return x * (x + 1) * (2 * x + 1) / 6;
}

// sum_{m' < m} (p+1-|m'|)^2 over m' >= -p: where order m's axial block
// starts
__device__ __forceinline__ int ax_offset(int m, int p) {
  return m <= 0 ? sum_sq(p + m) : sum_sq(p + 1) + sum_sq(p) - sum_sq(p + 1 - m);
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const typename Rows::Real* __restrict__ mpole,
                  const int* __restrict__ tgt, const int* __restrict__ src,
                  const int* __restrict__ tile_op,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_len,
                  const int* __restrict__ rc_of_op,
                  const typename Cplx<typename Rows::Real>::T* __restrict__ rot,
                  const typename Cplx<typename Rows::Real>::T* __restrict__ unrot,
                  const typename Cplx<typename Rows::Real>::T* __restrict__ ax,
                  int p, int tile, int nb, int na,
                  typename Rows::Real* __restrict__ local) {
  using R = typename Rows::Real;
  using C = typename Cplx<R>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* buf0 = reinterpret_cast<C*>(smem_raw);
  const int K = (p + 1) * (p + 1);
  C* buf1 = buf0 + (size_t)tile * K;
  __shared__ int s_tgt[64];

  const int op = tile_op[blockIdx.x];
  const long long e0 = tile_start[blockIdx.x];
  const int len = tile_len[blockIdx.x];
  const C* R_ = rot + (size_t)rc_of_op[op] * nb;
  const C* U_ = unrot + (size_t)rc_of_op[op] * nb;
  const C* A_ = ax + (size_t)op * na;
  const int n_el = tile * K;

  for (int t = threadIdx.x; t < len; t += blockDim.x)
    s_tgt[t] = tgt[e0 + t];
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int t = idx / K, j = idx - t * K;
    C v;
    v.x = 0;
    v.y = 0;
    if (t < len) v = Rows::load(mpole, (long long)src[e0 + t], K, j);
    buf0[idx] = v;
  }
  __syncthreads();

  // rotate: buf1[t][j] = sum_{k in deg n} buf0[t][k] R_n[k][j]
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int t = idx / K, j = idx - t * K;
    const int n = degree_of(j), dn = 2 * n + 1, jl = j - n * n;
    const C* blk = R_ + rot_offset(n) + jl;
    const C* row = buf0 + t * K + n * n;
    C acc;
    acc.x = 0;
    acc.y = 0;
    for (int kl = 0; kl < dn; ++kl) cmac(acc, row[kl], blk[kl * dn]);
    buf1[idx] = acc;
  }
  __syncthreads();

  // axial: buf0[t][(n, m)] = sum_{n' >= |m|} buf1[t][(n', -m)] A_m[n'][n]
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int t = idx / K, j = idx - t * K;
    const int n = degree_of(j), m = j - n * n - n;
    const int am = m < 0 ? -m : m;
    const int a = p + 1 - am;
    const C* blk = A_ + ax_offset(m, p) + (n - am);
    const C* row = buf1 + t * K;
    C acc;
    acc.x = 0;
    acc.y = 0;
    for (int il = 0; il < a; ++il) {
      const int ni = am + il;
      cmac(acc, row[ni * ni + ni - m], blk[il * a]);
    }
    buf0[idx] = acc;
  }
  __syncthreads();

  // unrotate, then add into the target's local row
  for (int idx = threadIdx.x; idx < n_el; idx += blockDim.x) {
    const int t = idx / K, j = idx - t * K;
    if (t >= len) continue;
    const int n = degree_of(j), dn = 2 * n + 1, jl = j - n * n;
    const C* blk = U_ + rot_offset(n) + jl;
    const C* row = buf0 + t * K + n * n;
    C acc;
    acc.x = 0;
    acc.y = 0;
    for (int kl = 0; kl < dn; ++kl) cmac(acc, row[kl], blk[kl * dn]);
    Rows::add(local, s_tgt[t], K, j, acc);
  }
}

template <typename Rows>
int rotate(const void* mpole, const void* tgt, const void* src,
           const void* tile_op, const void* tile_start, const void* tile_len,
           const void* rc_of_op, const void* rot, const void* unrot,
           const void* ax, long long ntiles, long long p, long long tile,
           void* local, void* stream) {
  using R = typename Rows::Real;
  using C = typename Cplx<R>::T;
  if (tile < 1 || tile > 64) return (int)cudaErrorInvalidValue;
  const long long K = (p + 1) * (p + 1);
  const size_t smem = 2 * (size_t)tile * K * sizeof(C);
  cudaError_t err = allow_smem(rotate_kernel<Rows>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (p + 1) * (2 * p + 1) * (2 * p + 3) / 3;
  const long long na = (p + 1) * (p + 1) + p * (p + 1) * (2 * p + 1) / 3;
  rotate_kernel<Rows><<<(unsigned)ntiles, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const R*)mpole, (const int*)tgt, (const int*)src,
      (const int*)tile_op, (const int*)tile_start, (const int*)tile_len,
      (const int*)rc_of_op, (const C*)rot, (const C*)unrot, (const C*)ax,
      (int)p, (int)tile, (int)nb, (int)na, (R*)local);
  return (int)cudaGetLastError();
}

// }}}

}  // namespace
}  // namespace boxtree_torch

extern "C" int m2l_classify_keys(const void* prefixes, const void* levels,
                                 const void* starts, const void* lists,
                                 const void* totp, const void* table,
                                 long long nedges, long long nrows,
                                 long long d, long long radius,
                                 long long nclasses, long long npossible,
                                 long long bits, void* keys, void* stream) {
  if (nedges == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((nedges + boxtree_torch::kThreads - 1) /
                 boxtree_torch::kThreads);
  boxtree_torch::classify_keys_kernel<<<blocks, boxtree_torch::kThreads, 0,
                                        (cudaStream_t)stream>>>(
      (const int64_t*)prefixes, (const int*)levels, (const int*)starts,
      (const int*)lists, (const int*)totp, (const int64_t*)table, nedges,
      nrows, (int)d, (int)radius, nclasses, npossible, (int)bits,
      (int64_t*)keys);
  return (int)cudaGetLastError();
}

extern "C" int m2l_classify_unpack(const void* keys, const void* starts,
                                   const void* lists, const void* totp,
                                   long long nedges, long long nrows,
                                   long long bits, void* tgt, void* src,
                                   void* hist, void* stream) {
  if (nedges == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((nedges + boxtree_torch::kThreads - 1) /
                 boxtree_torch::kThreads);
  boxtree_torch::classify_unpack_kernel<<<blocks, boxtree_torch::kThreads, 0,
                                          (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int*)starts, (const int*)lists,
      (const int*)totp, nedges, nrows, (int)bits, (int*)tgt, (int*)src,
      (unsigned long long*)hist);
  return (int)cudaGetLastError();
}

#define BOXTREE_TORCH_ROTATE_ENTRY(suffix, Rows)                              \
  extern "C" int m2l_rotate_##suffix(                                         \
      const void* mpole, const void* tgt, const void* src,                    \
      const void* tile_op, const void* tile_start, const void* tile_len,      \
      const void* rc_of_op, const void* rot, const void* unrot,               \
      const void* ax, long long ntiles, long long p, long long tile,          \
      void* local, void* stream) {                                            \
    return boxtree_torch::rotate<Rows>(mpole, tgt, src, tile_op, tile_start,  \
                                       tile_len, rc_of_op, rot, unrot, ax,    \
                                       ntiles, p, tile, local, stream);       \
  }

BOXTREE_TORCH_ROTATE_ENTRY(c128, boxtree_torch::InterleavedRows)
BOXTREE_TORCH_ROTATE_ENTRY(f64, boxtree_torch::PairRows<double>)
BOXTREE_TORCH_ROTATE_ENTRY(f32, boxtree_torch::PairRows<float>)
