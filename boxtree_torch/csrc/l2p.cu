// K30 l2p_laplace3d: 3D Laplace local-expansion evaluation,
// phi(t) = sum_{n,m} conj(R_n^m((t - c_b) / r_b)) L_n^m(b)
// for every target t that box b owns itself (its nonchild range, on any
// level), written once: complex for the _c128 entry point ((p+1)^2
// complex128 coefficients, interleaved re, im, over float64 geometry),
// its real part Rr.lr + Ri.li for _f32 / _f64 ([re | im] pairs of the
// geometry's type).  The caller masks the locals by level_to_order first.
//
// Replaces boxtree_tpu/models/expansion_base.py:1793 eval_locals with
// boxtree_tpu/models/laplace.py:477 _l2p_eval (pairs :588).
//
// No r = 0 guard: R is a polynomial in the offset, and a target at its
// box's centre reads L_0^0, as in the reference.
//
// Bound: bytes.  Each target is read once and its potential written once,
// each box's local row read once; the order-p recurrence a target (~(p+1)^2
// complex steps) is the work.  One CTA (one warp) per box with targets,
// one thread per target in strides of 32; the box's row, centre and scale
// are staged in shared memory once (2 (p+1)^2 + 4 values of T), and the
// harmonics never leave registers (harmonics.cuh), so no (particles x
// coefficients) array is stored.
#include "harmonics.cuh"
#include "laplace3d.cuh"

namespace boxtree_torch {
namespace {

constexpr int kL2PThreads = 32;

template <typename T, typename V>
__global__ void __launch_bounds__(kL2PThreads)
l2p_kernel(const T* __restrict__ targets, long long ntargets,
           const int* __restrict__ box_target_starts,
           const int* __restrict__ box_target_counts,
           const int* __restrict__ rows, const T* __restrict__ locs,
           const T* __restrict__ centers, long long nboxes,
           const T* __restrict__ box_scale, int p, V* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);
  const int nc = (p + 1) * (p + 1);  // complex coefficients
  const int ncoeff = 2 * nc;         // values of T: [re | im] or (re, im)
  // where coefficient i's real and imaginary parts sit
  const int re_step = kIsComplex<V> ? 2 : 1;
  const int im_off = kIsComplex<V> ? 1 : nc;
  const long long box = rows[blockIdx.x];
  const long long t0 = box_target_starts[box];
  const int nt = box_target_counts[box];
  for (int k = threadIdx.x; k < ncoeff; k += kL2PThreads)
    sl[k] = locs[box * ncoeff + k];
  if (threadIdx.x == 0) {
    sl[ncoeff] = centers[box];
    sl[ncoeff + 1] = centers[nboxes + box];
    sl[ncoeff + 2] = centers[2 * nboxes + box];
    sl[ncoeff + 3] = box_scale[box];
  }
  __syncthreads();
  const T s = sl[ncoeff + 3];

  for (int ti = threadIdx.x; ti < nt; ti += kL2PThreads) {
    const T x = (targets[t0 + ti] - sl[ncoeff]) / s;
    const T y = (targets[ntargets + t0 + ti] - sl[ncoeff + 1]) / s;
    const T z = (targets[2 * ntargets + t0 + ti] - sl[ncoeff + 2]) / s;
    T acc_re = T(0), acc_im = T(0);
    regular_pairs_foreach(x, y, z, p, [&](int n, int m, T rr, T ri) {
      const int i = re_step * (n * n + n + m);
      const T lr = sl[i], li = sl[i + im_off];
      if (m == 0) {
        // conj(R) L
        acc_re += rr * lr + ri * li;
        if (kIsComplex<V>) acc_im += rr * li - ri * lr;
      } else {
        // conj(R_n^m) L_n^m + conj(R_n^{-m}) L_n^{-m}, with
        // conj(R_n^{-m}) = (-1)^m R_n^m
        const int j = re_step * (n * n + n - m);
        const T sg = (m & 1) ? T(-1) : T(1);
        const T nr = sl[j], ni = sl[j + im_off];
        acc_re += rr * (lr + sg * nr) + ri * (li - sg * ni);
        if (kIsComplex<V>)
          acc_im += rr * (li + sg * ni) - ri * (lr - sg * nr);
      }
    });
    if constexpr (kIsComplex<V>)
      out[t0 + ti] = make_double2(acc_re, acc_im);
    else
      out[t0 + ti] = acc_re;
  }
}

template <typename T, typename V>
int l2p(const void* targets, long long ntargets, const void* bts,
        const void* btc, const void* rows, long long nrows,
        const void* locs, const void* centers, long long nboxes,
        const void* box_scale, long long order, void* out, void* stream) {
  if (nrows > 0) {
    const size_t smem = (2 * (order + 1) * (order + 1) + 4) * sizeof(T);
    const cudaError_t err = allow_smem(l2p_kernel<T, V>, smem);
    if (err != cudaSuccess) return (int)err;
    l2p_kernel<T, V><<<(unsigned)nrows, kL2PThreads, smem,
                       (cudaStream_t)stream>>>(
        (const T*)targets, ntargets, (const int*)bts, (const int*)btc,
        (const int*)rows, (const T*)locs, (const T*)centers, nboxes,
        (const T*)box_scale, (int)order, (V*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_L2P_ENTRY(suffix, T, V)                                \
  extern "C" int l2p_laplace3d_##suffix(                                    \
      const void* targets, long long ntargets, const void* bts,             \
      const void* btc, const void* rows, long long nrows, const void* locs, \
      const void* centers, long long nboxes, const void* box_scale,         \
      long long order, void* out, void* stream) {                           \
    return boxtree_torch::l2p<T, V>(targets, ntargets, bts, btc, rows,      \
                                    nrows, locs, centers, nboxes,           \
                                    box_scale, order, out, stream);         \
  }

BOXTREE_TORCH_L2P_ENTRY(f32, float, float)
BOXTREE_TORCH_L2P_ENTRY(f64, double, double)
BOXTREE_TORCH_L2P_ENTRY(c128, double, double2)
