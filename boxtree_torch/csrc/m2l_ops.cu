// The M2L operator tables of the Laplace wranglers, every used (level,
// translation class) operator of a setup in one launch.
//
// K69-K71 m2l_table_3d (_c128, _f64, _f32): for operator o with the
// translation t = ts[o] (c_tgt - c_src) and rscale r = rs[o], the irregular
// solid harmonics S_n^m(t / r) for n <= 2p by the port's recurrence
// (boxtree_torch/ops/solid_harmonics.py _harmonics_pairs), then
//   M[a][b] = ((-1)^{n_a} / r) S_{n_a + n_b}^{m_a + m_b}(t / r).
// Replaces boxtree_tpu/models/laplace.py:449 (complex) and :561 (pairs)
// _m2l_ops_device, with the truncation and transpose of
// expansion_base.py:398-424.
// K72-K74 m2l_table_2d (_c128, _f64, _f32): with z0 = -(tx + i ty) / r and
// the powers of 1 / z0,
//   M[l][k] = (-1)^k C(l+k-1, l) z0^-(l+k)   (k >= 1),
//   M[l][0] = -z0^-l / l (l >= 1),  M[0][0] = log(-z0) + log(r)
// with log(-z0) = 0.5 log(|t|^2 / r^2) + i atan2(ty, tx); the binomial
// factors come from the coef table ((-1)^k C(l+k-1, l), column 0 unused).
// Replaces laplace.py:160 (complex) and :271 (pairs) _m2l_ops_device.
//
// Both write the table K35 reads in its final form: operator o transposed
// (out[o][i][j] = M[j][i]), rows and columns past op_order[o] (the level's
// order under level_to_order) zeroed, as complex128 (interleaved re, im) or
// as the real pair blocks [[Mr, -Mi], [Mi, Mr]] of float64 or float32 (the
// cast at the store).  The float steps repeat the plain twins' (the
// recurrences and powers in float64, each step rounded, never an FMA): on
// an H100 the tables equal their twins' bit for bit on the chip_smoke.py
// paths (orders 8-20), and agree to 1.5e-14 at order 31; the 2D table's
// M[0][0] takes CUDA's log and atan2.
//
// Bound: bytes, the table written once (K^2 values an operator; at order 8
// in float32 pairs 105 KB an operator), against O(p^2) float64 steps of
// the recurrence.  One CTA (3D: a few, each recomputing the basis) per
// operator: the basis (3D, (2p+1)^2 complex values, 63.5 KB at order 31)
// or the powers (2D) in shared memory, then every thread stores output
// entries with the column index fastest, so the stores of a warp are
// contiguous.
#include "common.cuh"

namespace boxtree_torch {
namespace {

constexpr int kThreads = 256;
// output entries a CTA stores at most, before the operator is split over
// more CTAs (each recomputes the basis)
constexpr long long kEntriesPerCta = 16384;

__device__ __forceinline__ int degree_of(int a) {
  int n = (int)sqrt((double)a);
  while (n * n > a) --n;
  while ((n + 1) * (n + 1) <= a) ++n;
  return n;
}

// entry (i, j) of the transposed table of the complex operator M with
// entries (re, im) = value(a, b), K complex coefficients, keep n <= ord:
// writes out[o][i][j]
template <bool kPairs, typename Out, typename Value, typename Order>
__device__ __forceinline__ void store_entry(Out* out, long long base, int i,
                                            int j, int K, int KT, int ord,
                                            Order order_of, Value value) {
  if constexpr (kPairs) {
    const int hi = i / K, b = i - hi * K;
    const int hj = j / K, a = j - hj * K;
    double v = 0.0;
    if (order_of(a) <= ord && order_of(b) <= ord) {
      const double2 m = value(a, b);
      // [[Mr, -Mi], [Mi, Mr]] at row (hj, a), column (hi, b)
      v = hj == hi ? m.x : (hj == 0 ? -m.y : m.y);
    }
    out[base + (long long)i * KT + j] = (Out)v;
  } else {
    double2 m = make_double2(0.0, 0.0);
    if (order_of(j) <= ord && order_of(i) <= ord) m = value(j, i);
    reinterpret_cast<double2*>(out)[base + (long long)i * KT + j] = m;
  }
}

template <bool kPairs, typename Out>
__global__ void __launch_bounds__(kThreads)
    m2l_table_3d_kernel(const double* __restrict__ ts,
                        const double* __restrict__ rs,
                        const int* __restrict__ op_order, int p,
                        int rows_per_cta, Out* __restrict__ out) {
  extern __shared__ double smem[];
  const int P = 2 * p;
  const int nc2 = (P + 1) * (P + 1);
  double* sre = smem;
  double* sim = smem + nc2;
  const int op = blockIdx.x;
  const double r = rs[op];
  const double x = div_rn(ts[3 * op], r);
  const double y = div_rn(ts[3 * op + 1], r);
  const double z = div_rn(ts[3 * op + 2], r);
  const double r2 = add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
  const double rinv2 = div_rn(1.0, r2);
  // S_m^m, m = 0..2p: one chain
  if (threadIdx.x == 0) {
    double sr = sqrt_rn(rinv2), si = 0.0;
    sre[0] = sr;
    sim[0] = si;
    for (int m = 1; m <= P; ++m) {
      const double ar = sub_rn(mul_rn(sr, x), mul_rn(si, y));
      const double ai = add_rn(mul_rn(sr, y), mul_rn(si, x));
      const double c = (double)(2 * m - 1);
      sr = mul_rn(mul_rn(c, ar), rinv2);
      si = mul_rn(mul_rn(c, ai), rinv2);
      sre[m * m + 2 * m] = sr;
      sim[m * m + 2 * m] = si;
    }
  }
  __syncthreads();
  // S_n^m, n > m >= 0: one chain a column m
  for (int m = threadIdx.x; m <= P; m += blockDim.x) {
    double p2r = 0.0, p2i = 0.0;
    double p1r = sre[m * m + 2 * m], p1i = sim[m * m + 2 * m];
    for (int n = m + 1; n <= P; ++n) {
      const double cz = mul_rn((double)(2 * n - 1), z);
      double cr, ci;
      if (n == m + 1) {
        cr = mul_rn(mul_rn(cz, p1r), rinv2);
        ci = mul_rn(mul_rn(cz, p1i), rinv2);
      } else {
        const double c2 = (double)((n - 1) * (n - 1) - m * m);
        cr = mul_rn(sub_rn(mul_rn(cz, p1r), mul_rn(c2, p2r)), rinv2);
        ci = mul_rn(sub_rn(mul_rn(cz, p1i), mul_rn(c2, p2i)), rinv2);
      }
      sre[n * n + n + m] = cr;
      sim[n * n + n + m] = ci;
      p2r = p1r;
      p2i = p1i;
      p1r = cr;
      p1i = ci;
    }
  }
  __syncthreads();
  // S_n^-m = (-1)^m conj(S_n^m)
  for (int i = threadIdx.x; i < nc2; i += blockDim.x) {
    const int n = degree_of(i);
    const int m = i - n * n - n;
    if (m < 0) {
      const int j = n * n + n - m;
      const double s = (-m) & 1 ? -1.0 : 1.0;
      sre[i] = s * sre[j];
      sim[i] = -s * sim[j];
    }
  }
  __syncthreads();

  const int K = (p + 1) * (p + 1);
  const int KT = kPairs ? 2 * K : K;
  const int ord = op_order[op];
  const int row0 = blockIdx.y * rows_per_cta;
  const int row1 = min(KT, row0 + rows_per_cta);
  if (row0 >= row1) return;
  const long long base = (long long)op * KT * KT;
  const double sneg = div_rn(-1.0, r), spos = div_rn(1.0, r);
  auto value = [&](int a, int b) {
    const int na = degree_of(a), nb = degree_of(b);
    const int ma = a - na * na - na, mb = b - nb * nb - nb;
    const int ns = na + nb;
    const int idx = ns * ns + ns + ma + mb;
    const double s = na & 1 ? sneg : spos;
    return make_double2(mul_rn(s, sre[idx]), mul_rn(s, sim[idx]));
  };
  const long long nentries = (long long)(row1 - row0) * KT;
  for (long long e = threadIdx.x; e < nentries; e += blockDim.x) {
    const int i = row0 + (int)(e / KT);
    const int j = (int)(e % KT);
    store_entry<kPairs>(out, base, i, j, K, KT, ord,
                        [](int a) { return degree_of(a); }, value);
  }
}

template <bool kPairs, typename Out>
__global__ void __launch_bounds__(kThreads)
    m2l_table_2d_kernel(const double* __restrict__ ts,
                        const double* __restrict__ rs,
                        const double* __restrict__ logr,
                        const double* __restrict__ coef,
                        const int* __restrict__ op_order, int p,
                        int rows_per_cta, Out* __restrict__ out) {
  extern __shared__ double smem[];
  const int np = 2 * p + 2;
  double* zpr = smem;
  double* zpi = smem + np;
  const int op = blockIdx.x;
  const double tx = ts[2 * op], ty = ts[2 * op + 1], r = rs[op];
  if (threadIdx.x == 0) {
    const double x0 = div_rn(-tx, r), y0 = div_rn(-ty, r);
    const double n2 = add_rn(mul_rn(x0, x0), mul_rn(y0, y0));
    const double ixr = div_rn(x0, n2), ixi = div_rn(-y0, n2);
    double pr = 1.0, pi = 0.0;
    zpr[0] = pr;
    zpi[0] = pi;
    for (int i = 1; i < np; ++i) {
      const double qr = sub_rn(mul_rn(pr, ixr), mul_rn(pi, ixi));
      const double qi = add_rn(mul_rn(pr, ixi), mul_rn(pi, ixr));
      pr = qr;
      pi = qi;
      zpr[i] = pr;
      zpi[i] = pi;
    }
  }
  __syncthreads();

  const int K = p + 1;
  const int KT = kPairs ? 2 * K : K;
  const int ord = op_order[op];
  const int row0 = blockIdx.y * rows_per_cta;
  const int row1 = min(KT, row0 + rows_per_cta);
  if (row0 >= row1) return;
  const long long base = (long long)op * KT * KT;
  const double lr = add_rn(
      0.5 * log(div_rn(add_rn(mul_rn(tx, tx), mul_rn(ty, ty)),
                       mul_rn(r, r))),
      logr[op]);
  const double li = atan2(ty, tx);
  auto value = [&](int l, int k) {
    if (k >= 1) {
      const double c = coef[l * K + k];
      return make_double2(mul_rn(c, zpr[l + k]), mul_rn(c, zpi[l + k]));
    }
    if (l == 0) return make_double2(lr, li);
    const double linv = div_rn(1.0, (double)l);
    return make_double2(mul_rn(-zpr[l], linv), mul_rn(-zpi[l], linv));
  };
  const long long nentries = (long long)(row1 - row0) * KT;
  for (long long e = threadIdx.x; e < nentries; e += blockDim.x) {
    const int i = row0 + (int)(e / KT);
    const int j = (int)(e % KT);
    store_entry<kPairs>(out, base, i, j, K, KT, ord, [](int l) { return l; },
                        value);
  }
}

inline int rows_per_cta(int KT, int* nsplit) {
  long long split = ((long long)KT * KT + kEntriesPerCta - 1) /
                    kEntriesPerCta;
  if (split < 1) split = 1;
  if (split > KT) split = KT;
  const int rows = (int)((KT + split - 1) / split);
  *nsplit = (KT + rows - 1) / rows;
  return rows;
}

template <bool kPairs, typename Out>
int table_3d(const void* ts, const void* rs, const void* op_order,
             long long nops, long long p, void* out, void* stream) {
  const int K = (int)((p + 1) * (p + 1));
  const int KT = kPairs ? 2 * K : K;
  int nsplit;
  const int rows = rows_per_cta(KT, &nsplit);
  const size_t smem = 16 * (size_t)(2 * p + 1) * (2 * p + 1);
  cudaError_t err = allow_smem(m2l_table_3d_kernel<kPairs, Out>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nops, (unsigned)nsplit);
  m2l_table_3d_kernel<kPairs, Out>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const double*)ts, (const double*)rs, (const int*)op_order, (int)p,
          rows, (Out*)out);
  return (int)cudaGetLastError();
}

template <bool kPairs, typename Out>
int table_2d(const void* ts, const void* rs, const void* logr,
             const void* coef, const void* op_order, long long nops,
             long long p, void* out, void* stream) {
  const int K = (int)(p + 1);
  const int KT = kPairs ? 2 * K : K;
  int nsplit;
  const int rows = rows_per_cta(KT, &nsplit);
  const size_t smem = 16 * (size_t)(2 * p + 2);
  cudaError_t err = allow_smem(m2l_table_2d_kernel<kPairs, Out>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nops, (unsigned)nsplit);
  m2l_table_2d_kernel<kPairs, Out>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const double*)ts, (const double*)rs, (const double*)logr,
          (const double*)coef, (const int*)op_order, (int)p, rows,
          (Out*)out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_M2L_TABLE_ENTRY(suffix, pairs, Out)                    \
  extern "C" int m2l_table_3d_##suffix(const void* ts, const void* rs,       \
                                       const void* op_order, long long nops, \
                                       long long p, void* out,               \
                                       void* stream) {                       \
    return boxtree_torch::table_3d<pairs, Out>(ts, rs, op_order, nops, p,    \
                                               out, stream);                 \
  }                                                                          \
  extern "C" int m2l_table_2d_##suffix(                                      \
      const void* ts, const void* rs, const void* logr, const void* coef,    \
      const void* op_order, long long nops, long long p, void* out,          \
      void* stream) {                                                        \
    return boxtree_torch::table_2d<pairs, Out>(ts, rs, logr, coef, op_order, \
                                               nops, p, out, stream);        \
  }

BOXTREE_TORCH_M2L_TABLE_ENTRY(c128, false, double)
BOXTREE_TORCH_M2L_TABLE_ENTRY(f64, true, double)
BOXTREE_TORCH_M2L_TABLE_ENTRY(f32, true, float)
