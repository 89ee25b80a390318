// The row moves of the distributed FMM's multipole exchange and its
// masked merges.
//
// K80 pack_rows: the send buffer of one exchange stage,
//   send[j, :] = idx[j] >= 0 ? mp[idx[j], :] : 0,
// the masked gather of boxtree_tpu/parallel/distributed.py:494-497
// (inside _make_mpole_exchange, run by the _build_step at :510).
// K81 unpack_rows: the receive side of one stage, for every j with
// idx[j] >= 0,
//   op "add": mp[idx[j], :] += recv[j, :]    (distributed.py:500-503)
//   op "set": mp[idx[j], :]  = recv[j, :]    (distributed.py:504-505).
// A stage's ids come from one np.nonzero of a box mask (:140; the port's
// schedule takes them from one torch.nonzero), so they are unique within a
// stage: every destination row has one writer, and no atomics are needed.
// K82 masked_merge: out[i, :] += keep[map[i]] ? x[i, :] : 0, in place;
// with no mask (has_keep = 0) out[i, :] += x[i, :].  It masks the source
// weights to a rank's responsible boxes (out zeroed, map the source's box;
// distributed.py:530), merges the ranks' potentials masked to their
// responsible boxes (map the target's box; :552-557) and, with no mask,
// sums the partial multipoles of the allreduce flavour (the dense psum of
// :490).  A row that is not kept is not written at all.
//
// Entry points _f32 / _f64 / _c128: every kernel moves whole rows of w
// values; a complex128 row of w coefficients is 2 w doubles (interleaved
// re, im), so the _c128 entry points run the double kernels on twice the
// width.
//
// Bound: bytes.  Each kernel reads and writes every value of its rows once
// (K82 only the rows it keeps) and does at most one add a value.  K80 and K81 give a warp to a row (162
// values on the main path: coalesced 32 consecutive values a step) and a
// CTA of 8 warps to 8 rows; K82 gives a thread to a value, its row's keep
// flag read through the map (a cached gather), over a grid-stride loop.
#include "common.cuh"

namespace boxtree_torch {
namespace {

constexpr int kWarpsPerCta = 8;

template <typename T>
__global__ void pack_rows_kernel(const T* __restrict__ mp,
                                 const int32_t* __restrict__ idx,
                                 long long n, long long w,
                                 T* __restrict__ send) {
  const long long j =
      blockIdx.x * (long long)kWarpsPerCta + (threadIdx.x >> 5);
  if (j >= n) return;
  const int lane = threadIdx.x & 31;
  const long long src = idx[j];
  T* dst = send + j * w;
  if (src < 0) {
    for (long long c = lane; c < w; c += 32) dst[c] = T(0);
    return;
  }
  const T* row = mp + src * w;
  for (long long c = lane; c < w; c += 32) dst[c] = row[c];
}

template <typename T>
__global__ void unpack_rows_kernel(T* __restrict__ mp,
                                   const int32_t* __restrict__ idx,
                                   const T* __restrict__ recv, long long n,
                                   long long w, int set) {
  const long long j =
      blockIdx.x * (long long)kWarpsPerCta + (threadIdx.x >> 5);
  if (j >= n) return;
  const long long dst = idx[j];
  if (dst < 0) return;
  const int lane = threadIdx.x & 31;
  T* row = mp + dst * w;
  const T* in = recv + j * w;
  if (set) {
    for (long long c = lane; c < w; c += 32) row[c] = in[c];
  } else {
    for (long long c = lane; c < w; c += 32) row[c] = row[c] + in[c];
  }
}

template <typename T>
__global__ void masked_merge_kernel(T* __restrict__ out,
                                    const T* __restrict__ x,
                                    const uint8_t* __restrict__ keep,
                                    const int32_t* __restrict__ map,
                                    long long n, long long w, int has_keep) {
  const long long total = n * w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += stride) {
    if (has_keep && !__ldg(keep + __ldg(map + e / w))) continue;
    out[e] = out[e] + x[e];
  }
}

inline unsigned row_ctas(long long n) {
  return (unsigned)((n + kWarpsPerCta - 1) / kWarpsPerCta);
}

template <typename T>
int pack_rows(const void* mp, const void* idx, long long n, long long w,
              void* send, void* stream) {
  if (n > 0)
    pack_rows_kernel<T><<<row_ctas(n), 32 * kWarpsPerCta, 0,
                          (cudaStream_t)stream>>>(
        (const T*)mp, (const int32_t*)idx, n, w, (T*)send);
  return (int)cudaGetLastError();
}

template <typename T>
int unpack_rows(void* mp, const void* idx, const void* recv, long long n,
                long long w, long long set, void* stream) {
  if (n > 0)
    unpack_rows_kernel<T><<<row_ctas(n), 32 * kWarpsPerCta, 0,
                            (cudaStream_t)stream>>>(
        (T*)mp, (const int32_t*)idx, (const T*)recv, n, w, (int)set);
  return (int)cudaGetLastError();
}

template <typename T>
int masked_merge(void* out, const void* x, const void* keep, const void* map,
                 long long n, long long w, long long has_keep, void* stream) {
  const long long total = n * w;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    // a grid-stride loop past 132 SMs x 16 CTAs
    if (blocks > 132 * 16) blocks = 132 * 16;
    masked_merge_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (T*)out, (const T*)x, (const uint8_t*)keep, (const int32_t*)map, n,
        w, (int)has_keep);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_EXCHANGE_ENTRY(suffix, T, LANES)                        \
  extern "C" int pack_rows_##suffix(const void* mp, const void* idx,          \
                                    long long n, long long w, void* send,     \
                                    void* stream) {                           \
    return boxtree_torch::pack_rows<T>(mp, idx, n, (LANES) * w, send,         \
                                       stream);                               \
  }                                                                           \
  extern "C" int unpack_rows_##suffix(void* mp, const void* idx,              \
                                      const void* recv, long long n,          \
                                      long long w, long long set,             \
                                      void* stream) {                         \
    return boxtree_torch::unpack_rows<T>(mp, idx, recv, n, (LANES) * w, set,  \
                                         stream);                             \
  }                                                                           \
  extern "C" int masked_merge_##suffix(void* out, const void* x,              \
                                       const void* keep, const void* map,     \
                                       long long n, long long w,              \
                                       long long has_keep, void* stream) {    \
    return boxtree_torch::masked_merge<T>(out, x, keep, map, n, (LANES) * w,  \
                                          has_keep, stream);                  \
  }

BOXTREE_TORCH_EXCHANGE_ENTRY(f32, float, 1)
BOXTREE_TORCH_EXCHANGE_ENTRY(f64, double, 1)
BOXTREE_TORCH_EXCHANGE_ENTRY(c128, double, 2)
