// The translation stages of the expansion wranglers: gathered rows of
// expansions times small operator tables.
//
// K35 m2l_translate: M2L, for every level in one launch.  Each target
// parent p (the parents with a target-or-target-parent child, padded to
// whole tiles per level), each target digit qt and each output coefficient:
//   local[child(p, qt)] = sum_{(j, qs): opid[lev, j, qs, qt] >= 0}
//                         mpole[child(pmap[p, j], qs)] @ opsT[opid[...]]
// where pmap[p, j] is p's colleague in offset slot j; a missing colleague
// or child adds 0, and a row is written (not added) only where child(p, qt)
// is a target-or-target-parent box.  Replaces
// boxtree_tpu/models/expansion_base.py:1016 _m2l_parent_dense (its plan at
// :915 _build_m2l_parent_plan).
// K36 m2m_translate: M2M of one level, bottom-up one launch a level: for
// each parent row of level lev - 1,
//   mpole[par] += sum_q mpole[child(par, q)] @ m2m_opsT[lev][q]
// summed over q in digit order.  Replaces expansion_base.py:684
// coarsen_multipoles over particle_blocks.py:93 grouped_matmul.
// K37 l2l_translate: L2L of one level, top-down one launch a level: for
// each target-or-target-parent parent p of level lev - 1 and digit q whose
// child c is a target-or-target-parent box,
//   local[c] += local[p] @ l2l_opsT[lev][q].
// Replaces expansion_base.py:723 refine_locals over grouped_matmul.
//
// Entry points: _f32 / _f64 (real coefficients: the real-pair wranglers)
// and _c128 (complex128 coefficients, interleaved re, im).  Every operator
// is (K, K), transposed for row vectors: row k of opsT holds the weights
// of input coefficient k.
//
// Bound: operations.  K35 multiplies each row's K coefficients by a (K, K)
// operator for every List-2 pair (2 K^2 flops a pair in real arithmetic,
// 8 K^2 for complex), reading only the multipoles, the table and the
// plan; at order 8 in float32 on the main path that is ~1e12 flops against
// ~0.1 GB of data.  The three kernels share one design: a CTA owns a tile
// of BM rows (parents) by BN output coefficients (and, for K35 and K37, one
// target digit), and runs one gathered product over its (pair, k-tile)
// steps: its rows' source expansions, found through the plan's index
// tables (K35: a precomputed (pair, row) table of source boxes), and the
// pair's operator column tile are staged through registers into one of two
// shared-memory buffers while the other feeds the product, so the loads
// of a step overlap the arithmetic of the one before: in float32 on the
// SIMT cores (TM x TN outputs a thread, fused multiply-adds, no TF32), in
// float64 and complex128 on the FP64 tensor cores (mma.sync m8n8k4, IEEE
// double products and sums; a complex product is four real ones).  No
// gathered copy is made in device memory, and the reduction is tiled by
// BK, so the shared memory (under 70 KiB) does not grow with K.
// Every output row is owned by one CTA, so there are no atomics and the
// result does not depend on the order in which CTAs run.  A CTA first lists
// the pairs its rows use (K35: the (slot, source digit) pairs with an
// operator and a source; K36: the digits with a child) and skips the rest,
// and a tile with no target row exits at once.
#include <type_traits>

#include "common.cuh"

namespace boxtree_torch {
namespace {

__device__ __forceinline__ void mac(float& c, float a, float b) {
  c = fmaf(a, b, c);
}

template <typename V>
__device__ __forceinline__ V zero_v() {
  return V(0);
}
template <>
__device__ __forceinline__ double2 zero_v<double2>() {
  return make_double2(0.0, 0.0);
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(double& a, double b) { a += b; }
__device__ __forceinline__ void add_to(double2& a, double2 b) {
  a.x += b.x;
  a.y += b.y;
}

// CTA tile: BM rows by BN output coefficients, the reduction in steps of
// BK, TM x TN outputs a thread.  The plan pads K35's rows per level to a
// multiple of kRowPad, which every BM divides.
constexpr int kRowPad = 128;
// the most (slot, source digit) pairs of K35 (3D: 27 slots, 8 digits)
constexpr int kMaxPairs = 27 * 8;

// float: the SIMT cores, TM x TN outputs a thread, each thread's rows and
// columns contiguous (read as float4); double and double2 (complex128): the
// FP64 tensor cores (mma.sync m8n8k4), a WM x WN tile a warp.  PA / PB pad
// the staged tiles' rows: to whole float4 for the SIMT product, against
// bank conflicts for the tensor-core fragments, which read 4 k-rows by 8
// columns a warp (a row stride of 4 mod 16 doubles, or 2 mod 8 double2,
// puts them in distinct banks).  The tiles take 28-70 KiB of dynamic
// shared memory; two CTAs fit an SM.
template <typename V>
struct Tiling;
template <>
struct Tiling<float> {
  static constexpr int BM = 128, BN = 64, BK = 16, PA = 4, PB = 0;
  static constexpr int TM = 8, TN = 8, NT = (BM / TM) * (BN / TN);
};
template <>
struct Tiling<double> {
  static constexpr int BM = 64, BN = 64, BK = 16, PA = 4, PB = 4;
  static constexpr int WM = 32, WN = 32, NT = 32 * (BM / WM) * (BN / WN);
};
template <>
struct Tiling<double2> {
  static constexpr int BM = 64, BN = 64, BK = 16, PA = 2, PB = 2;
  static constexpr int WM = 32, WN = 16, NT = 32 * (BM / WM) * (BN / WN);
};

template <typename V>
struct Cfg : Tiling<V> {
  using T = Tiling<V>;
  static constexpr int NT = T::NT;
  // per thread: A and B values staged a step, rows / k strides
  static constexpr int AP = T::BM * T::BK / NT, BP = T::BK * T::BN / NT;
  static constexpr int RS = NT / T::BK, KS = NT / T::BN;
  static_assert(kRowPad % T::BM == 0, "tiles must not cross a level");
  static_assert(NT >= T::BM, "one thread per row loads the row tables");
  static_assert(NT % T::BK == 0 && NT % T::BN == 0, "whole staging rows");
};

template <typename V>
struct alignas(16) Smem {
  // two stages; A transposed
  V a[2][Cfg<V>::BK][Cfg<V>::BM + Cfg<V>::PA];
  V b[2][Cfg<V>::BK][Cfg<V>::BN + Cfg<V>::PB];
  int src[Cfg<V>::BM];
  int dst[Cfg<V>::BM];
  // the (pair, operator) steps of the CTA, in pair order
  int flag[kMaxPairs];
  int act[kMaxPairs];
  int act_op[kMaxPairs];
  int nact;
};

// out[row, n] = v (kAdd: +=) where row >= 0 and n < K
template <bool kAdd, typename V>
__device__ __forceinline__ void put(V* out, long long row, long long n,
                                    long long K, V v) {
  if (row < 0 || n >= K) return;
  if (kAdd) {
    add_to(out[row * K + n], v);
  } else {
    out[row * K + n] = v;
  }
}

// The SIMT product (float): rows TM ty + i, columns TN tx + j of the tile.
template <typename V>
struct Acc {
  using C = Cfg<V>;
  static constexpr int NX = C::BN / C::TN;
  static_assert(C::TM == 8 && C::TN == 8, "two float4 a row and a column");
  V v[C::TM][C::TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) v[i][j] = zero_v<V>();
  }

  __device__ __forceinline__ void step(const Smem<V>& sm, int buf) {
    const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      const float4* pa =
          reinterpret_cast<const float4*>(&sm.a[buf][kk][C::TM * ty]);
      const float4* pb =
          reinterpret_cast<const float4*>(&sm.b[buf][kk][C::TN * tx]);
      const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) mac(v[i][j], a[i], b[j]);
    }
  }

  template <bool kAdd>
  __device__ __forceinline__ void store(const Smem<V>& sm, V* out,
                                        long long K, long long n0) const {
    const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        put<kAdd>(out, sm.dst[C::TM * ty + i], n0 + C::TN * tx + j, K,
                  v[i][j]);
  }
};

// d += a b on the FP64 tensor cores: an 8 x 4 by 4 x 8 product a warp.
// Lane l holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and d = D[l / 4][2
// (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The warp's WM x WN tile as (WM / 8) x (WN / 8) tensor-core tiles: real
// (double) or the real and imaginary parts of complex products (double2,
// four real products each).
template <typename V>
struct MmaAcc {
  using C = Cfg<V>;
  static constexpr bool kCplx = std::is_same<V, double2>::value;
  static constexpr int MI = C::WM / 8, NJ = C::WN / 8, WX = C::BN / C::WN;
  double re[MI][NJ][2], im[kCplx ? MI : 1][kCplx ? NJ : 1][2];

  __device__ __forceinline__ int wm() const {
    return (threadIdx.x / 32) / WX * C::WM;
  }
  __device__ __forceinline__ int wn() const {
    return (threadIdx.x / 32) % WX * C::WN;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          re[i][j][e] = 0.0;
          if constexpr (kCplx) im[i][j][e] = 0.0;
        }
  }

  __device__ __forceinline__ void step(const Smem<V>& sm, int buf) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int m0 = wm(), n0 = wn();
#pragma unroll
    for (int k4 = 0; k4 < C::BK; k4 += 4) {
      V a[MI], b[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) a[i] = sm.a[buf][k4 + t][m0 + 8 * i + g];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = sm.b[buf][k4 + t][n0 + 8 * j + g];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if constexpr (kCplx) {
            dmma(re[i][j], a[i].x, b[j].x);
            dmma(re[i][j], -a[i].y, b[j].y);
            dmma(im[i][j], a[i].x, b[j].y);
            dmma(im[i][j], a[i].y, b[j].x);
          } else {
            dmma(re[i][j], a[i], b[j]);
          }
        }
    }
  }

  template <bool kAdd>
  __device__ __forceinline__ void store(const Smem<V>& sm, V* out,
                                        long long K, long long n0) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const long long row = sm.dst[wm() + 8 * i + g];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long n = n0 + wn() + 8 * j + 2 * t + e;
          if constexpr (kCplx) {
            put<kAdd>(out, row, n, K, make_double2(re[i][j][e], im[i][j][e]));
          } else {
            put<kAdd>(out, row, n, K, re[i][j][e]);
          }
        }
    }
  }
};

template <typename V>
struct AccOf {
  using type = MmaAcc<V>;
};
template <>
struct AccOf<float> {
  using type = Acc<float>;
};

// acc += sum over the CTA's pairs p < npairs of
//   vals[src_row(p, r), :] @ op_of(p)[:, n0:n0 + BN]
// for its rows r (a row with src_row < 0 is zero): the reduction over
// (pair, k-tile) steps, each step's operands staged through registers
// into one of two shared-memory buffers while the other feeds the
// product, so that the loads of step s + 1 overlap the arithmetic of step
// s.  src_row is read once a pair, at its first step.
template <typename V, class A, class SrcRow, class OpOf>
__device__ __forceinline__ void gemm(A& acc, Smem<V>& sm, const V* vals,
                                     long long K, long long n0, int npairs,
                                     SrcRow src_row, OpOf op_of) {
  using C = Cfg<V>;
  const int tid = threadIdx.x;
  const int ka = tid % C::BK, ra = tid / C::BK;
  const int nb = tid % C::BN, kb = tid / C::BN;
  const int nk = (int)((K + C::BK - 1) / C::BK);
  const long long nsteps = (long long)npairs * nk;
  if (nsteps == 0) return;

  int srow[C::AP];
  V areg[C::AP], breg[C::BP];
  int fp = 0, fk = 0;  // the pair and k-tile of the next step to fetch
  auto fetch = [&]() {
    if (fk == 0) {
#pragma unroll
      for (int i = 0; i < C::AP; ++i) srow[i] = src_row(fp, ra + i * C::RS);
    }
    const V* op = op_of(fp);
    const long long k0 = (long long)fk * C::BK;
    const long long k = k0 + ka;
#pragma unroll
    for (int i = 0; i < C::AP; ++i)
      areg[i] = (srow[i] >= 0 && k < K) ? vals[(long long)srow[i] * K + k]
                                        : zero_v<V>();
    const long long n = n0 + nb;
#pragma unroll
    for (int i = 0; i < C::BP; ++i) {
      const long long kk = k0 + kb + i * C::KS;
      breg[i] = (kk < K && n < K) ? op[kk * K + n] : zero_v<V>();
    }
    if (++fk == nk) {
      fk = 0;
      ++fp;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < C::AP; ++i) sm.a[buf][ka][ra + i * C::RS] = areg[i];
#pragma unroll
    for (int i = 0; i < C::BP; ++i) sm.b[buf][kb + i * C::KS][nb] = breg[i];
  };

  fetch();
  stash(0);
  __syncthreads();
  for (long long s = 0; s < nsteps; ++s) {
    const int buf = (int)(s & 1);
    const bool more = s + 1 < nsteps;
    if (more) fetch();
    acc.step(sm, buf);
    if (more) stash(buf ^ 1);
    __syncthreads();
  }
}

// sm.act / sm.act_op / sm.nact: the pairs with sm.flag >= 0 (the
// operator), in pair order
template <typename V>
__device__ __forceinline__ void compact_pairs(Smem<V>& sm, int npairs) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int p = 0; p < npairs; ++p) {
      if (sm.flag[p] >= 0) {
        sm.act[n] = p;
        sm.act_op[n] = sm.flag[p];
        ++n;
      }
    }
    sm.nact = n;
  }
  __syncthreads();
}

template <typename V>
__global__ void __launch_bounds__(Cfg<V>::NT, 2)
m2l_kernel(const V* __restrict__ mpole, const V* __restrict__ ops,
           const int* __restrict__ opid, const int* __restrict__ rows,
           const int* __restrict__ src, const int* __restrict__ row_level,
           const int* __restrict__ tgt_child, long long npad, int npairs,
           int nchild, long long K, V* __restrict__ out) {
  using C = Cfg<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<V>& sm = *reinterpret_cast<Smem<V>*>(smem_raw);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * C::BM;
  const int qt = blockIdx.y;
  const long long n0 = (long long)blockIdx.z * C::BN;
  const int lev = row_level[r0];

  int any = 0;
  if (tid < C::BM) {
    const long long p = rows[r0 + tid];
    const int t = p >= 0 ? tgt_child[p * nchild + qt] : -1;
    sm.dst[tid] = t;
    any = t >= 0;
  }
  if (!__syncthreads_or(any)) return;

  // the (slot, source digit) pairs with an operator and a source child
  // for some row with a target: the rows' sources four at a time
  const int* op_lev = opid + (long long)lev * npairs * nchild;
  for (int p = tid; p < npairs; p += C::NT) {
    const int o = op_lev[p * nchild + qt];
    int f = -1;
    if (o >= 0) {
      const int4* sp =
          reinterpret_cast<const int4*>(src + (long long)p * npad + r0);
      for (int r = 0; r < C::BM / 4 && f < 0; ++r) {
        const int4 v = sp[r];
        if ((v.x >= 0 && sm.dst[4 * r] >= 0) ||
            (v.y >= 0 && sm.dst[4 * r + 1] >= 0) ||
            (v.z >= 0 && sm.dst[4 * r + 2] >= 0) ||
            (v.w >= 0 && sm.dst[4 * r + 3] >= 0))
          f = o;
      }
    }
    sm.flag[p] = f;
  }
  compact_pairs(sm, npairs);

  typename AccOf<V>::type acc;
  acc.zero();
  gemm(
      acc, sm, mpole, K, n0, sm.nact,
      [&](int p, int r) {
        return sm.dst[r] >= 0 ? src[(long long)sm.act[p] * npad + r0 + r]
                              : -1;
      },
      [&](int p) { return ops + (long long)sm.act_op[p] * K * K; });
  acc.template store<false>(sm, out, K, n0);
}

template <typename V>
__global__ void __launch_bounds__(Cfg<V>::NT, 2)
m2m_kernel(V* mpole, const V* __restrict__ ops,
           const int* __restrict__ child, long long row0, long long nrows,
           int nchild, long long K) {
  using C = Cfg<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<V>& sm = *reinterpret_cast<Smem<V>*>(smem_raw);
  const int tid = threadIdx.x;
  const long long r = (long long)blockIdx.x * C::BM + tid;
  const long long n0 = (long long)blockIdx.z * C::BN;

  int any = 0;
  if (tid < C::BM) {
    long long par = -1;
    if (r < nrows) {
      for (int q = 0; q < nchild; ++q)
        if (child[(row0 + r) * nchild + q] >= 0) par = row0 + r;
    }
    sm.dst[tid] = (int)par;
    any = par >= 0;
  }
  if (!__syncthreads_or(any)) return;

  // the digits with a child in some row
  for (int q = tid; q < nchild; q += C::NT) {
    int f = -1;
    for (int i = 0; i < C::BM && f < 0; ++i) {
      const long long par = sm.dst[i];
      if (par >= 0 && child[par * nchild + q] >= 0) f = q;
    }
    sm.flag[q] = f;
  }
  compact_pairs(sm, nchild);

  typename AccOf<V>::type acc;
  acc.zero();
  gemm(
      acc, sm, mpole, K, n0, sm.nact,
      [&](int p, int i) {
        const long long par = sm.dst[i];
        return par >= 0 ? child[par * nchild + sm.act[p]] : -1;
      },
      [&](int p) { return ops + (long long)sm.act_op[p] * K * K; });
  acc.template store<true>(sm, mpole, K, n0);
}

template <typename V>
__global__ void __launch_bounds__(Cfg<V>::NT, 2)
l2l_kernel(V* local, const V* __restrict__ ops,
           const int* __restrict__ rows, const int* __restrict__ tgt_child,
           long long nrows, int nchild, long long K) {
  using C = Cfg<V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<V>& sm = *reinterpret_cast<Smem<V>*>(smem_raw);
  const int tid = threadIdx.x;
  const long long r = (long long)blockIdx.x * C::BM + tid;
  const int q = blockIdx.y;
  const long long n0 = (long long)blockIdx.z * C::BN;

  int any = 0;
  if (tid < C::BM) {
    const long long p = r < nrows ? rows[r] : -1;
    const int t = p >= 0 ? tgt_child[p * nchild + q] : -1;
    sm.dst[tid] = t;
    sm.src[tid] = t >= 0 ? (int)p : -1;
    any = t >= 0;
  }
  if (!__syncthreads_or(any)) return;

  typename AccOf<V>::type acc;
  acc.zero();
  const V* op = ops + (long long)q * K * K;
  gemm(
      acc, sm, local, K, n0, 1, [&](int, int i) { return sm.src[i]; },
      [&](int) { return op; });
  acc.template store<true>(sm, local, K, n0);
}

template <typename V>
unsigned col_tiles(long long K) {
  return (unsigned)((K + Cfg<V>::BN - 1) / Cfg<V>::BN);
}

template <typename V>
int m2l(const void* mpole, const void* ops, const void* opid,
        const void* rows, const void* src, const void* row_level,
        const void* tgt_child, long long npad, long long npairs,
        long long nchild, long long K, void* out, void* stream) {
  if (npad % kRowPad != 0 || npairs > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  if (npad > 0 && K > 0) {
    const dim3 grid((unsigned)(npad / Cfg<V>::BM), (unsigned)nchild,
                    col_tiles<V>(K));
    const cudaError_t err = allow_smem(m2l_kernel<V>, sizeof(Smem<V>));
    if (err != cudaSuccess) return (int)err;
    m2l_kernel<V><<<grid, Cfg<V>::NT, sizeof(Smem<V>),
                    (cudaStream_t)stream>>>(
        (const V*)mpole, (const V*)ops, (const int*)opid, (const int*)rows,
        (const int*)src, (const int*)row_level, (const int*)tgt_child, npad,
        (int)npairs, (int)nchild, K, (V*)out);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int m2m(void* mpole, const void* ops, const void* child, long long row0,
        long long nrows, long long nchild, long long K, void* stream) {
  if (nchild > kMaxPairs) return (int)cudaErrorInvalidValue;
  if (nrows > 0 && K > 0) {
    const dim3 grid((unsigned)((nrows + Cfg<V>::BM - 1) / Cfg<V>::BM), 1,
                    col_tiles<V>(K));
    const cudaError_t err = allow_smem(m2m_kernel<V>, sizeof(Smem<V>));
    if (err != cudaSuccess) return (int)err;
    m2m_kernel<V><<<grid, Cfg<V>::NT, sizeof(Smem<V>),
                    (cudaStream_t)stream>>>(
        (V*)mpole, (const V*)ops, (const int*)child, row0, nrows,
        (int)nchild, K);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int l2l(void* local, const void* ops, const void* rows,
        const void* tgt_child, long long nrows, long long nchild,
        long long K, void* stream) {
  if (nrows > 0 && K > 0) {
    const dim3 grid((unsigned)((nrows + Cfg<V>::BM - 1) / Cfg<V>::BM),
                    (unsigned)nchild, col_tiles<V>(K));
    const cudaError_t err = allow_smem(l2l_kernel<V>, sizeof(Smem<V>));
    if (err != cudaSuccess) return (int)err;
    l2l_kernel<V><<<grid, Cfg<V>::NT, sizeof(Smem<V>),
                    (cudaStream_t)stream>>>(
        (V*)local, (const V*)ops, (const int*)rows, (const int*)tgt_child,
        nrows, (int)nchild, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

#define BOXTREE_TORCH_TRANSLATE_ENTRY(suffix, V)                             \
  extern "C" int m2l_translate_##suffix(                                    \
      const void* mpole, const void* ops, const void* opid,                 \
      const void* rows, const void* src, const void* row_level,             \
      const void* tgt_child, long long npad, long long npairs,              \
      long long nchild, long long K, void* out, void* stream) {             \
    return boxtree_torch::m2l<V>(mpole, ops, opid, rows, src, row_level,    \
                                 tgt_child, npad, npairs, nchild, K, out,   \
                                 stream);                                   \
  }                                                                         \
  extern "C" int m2m_translate_##suffix(                                    \
      void* mpole, const void* ops, const void* child, long long row0,      \
      long long nrows, long long nchild, long long K, void* stream) {       \
    return boxtree_torch::m2m<V>(mpole, ops, child, row0, nrows, nchild, K, \
                                 stream);                                   \
  }                                                                         \
  extern "C" int l2l_translate_##suffix(                                    \
      void* local, const void* ops, const void* rows,                       \
      const void* tgt_child, long long nrows, long long nchild,             \
      long long K, void* stream) {                                          \
    return boxtree_torch::l2l<V>(local, ops, rows, tgt_child, nrows,        \
                                 nchild, K, stream);                        \
  }

BOXTREE_TORCH_TRANSLATE_ENTRY(f32, float)
BOXTREE_TORCH_TRANSLATE_ENTRY(f64, double)
BOXTREE_TORCH_TRANSLATE_ENTRY(c128, double2)
