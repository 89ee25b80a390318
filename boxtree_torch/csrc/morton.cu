// K1 morton_encode: full-depth Morton keys of particle coordinates, packed
// with the particle index for a key-only sort.
//
// Replaces boxtree_tpu/ops/morton.py:123 encode_points (cells_from_coords +
// interleave) together with the key packing of boxtree_tpu/tree/build.py:
// 146-157 (_phase_a).  The bounding box and root extent stay torch.amin /
// amax in the wrapper, and the sort stays torch.sort.
//
// Bound: memory.  Each point reads d coordinates and writes one int64 key
// (20 bytes a point in 3D f32, about 6 us per 1e6 points at 3.35 TB/s); the
// integer work is a few dozen ALU operations.  One thread per point with
// coalesced loads of each coordinate row.
//
// The keys must equal the plain version bit for bit, so the float steps run
// in the coordinates' own type and in the reference's order: subtract,
// IEEE divide, multiply by the power of two 2^depth (exact), floor.  Nothing
// here can be contracted into an FMA, and the build uses no fast-math flag.
#include "common.cuh"
#include "morton.cuh"

namespace boxtree_torch {
namespace {

template <typename T>
__global__ void morton_encode_kernel(const T* __restrict__ coords,
                                     long long n,
                                     const T* __restrict__ bbox_min,
                                     const T* __restrict__ root_extent,
                                     int d, int depth, int iota_bits,
                                     int64_t* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T extent = *root_extent;
  const T nbuckets = (T)(1ll << depth);
  const long long top = (1ll << depth) - 1;
  uint64_t code = 0;
  for (int ax = 0; ax < d; ++ax) {
    const T scaled = (coords[ax * n + i] - bbox_min[ax]) / extent;
    long long cell = (long long)floor_t(scaled * nbuckets);
    cell = cell < 0 ? 0 : (cell > top ? top : cell);
    code |= spread_bits((uint64_t)cell, d) << (d - 1 - ax);
  }
  if (iota_bits >= 0) code = (code << iota_bits) | (uint64_t)i;
  out[i] = (int64_t)code;
}

template <typename T>
int morton_encode(const void* coords, long long n, const void* bbox_min,
                  const void* root_extent, long long d, long long depth,
                  long long iota_bits, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    morton_encode_kernel<T><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
        (const T*)coords, n, (const T*)bbox_min, (const T*)root_extent,
        (int)d, (int)depth, (int)iota_bits, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace boxtree_torch

extern "C" int morton_encode_f32(const void* coords, long long n,
                                 const void* bbox_min, const void* extent,
                                 long long d, long long depth,
                                 long long iota_bits, void* out,
                                 void* stream) {
  return boxtree_torch::morton_encode<float>(coords, n, bbox_min, extent, d,
                                             depth, iota_bits, out, stream);
}

extern "C" int morton_encode_f64(const void* coords, long long n,
                                 const void* bbox_min, const void* extent,
                                 long long d, long long depth,
                                 long long iota_bits, void* out,
                                 void* stream) {
  return boxtree_torch::morton_encode<double>(coords, n, bbox_min, extent, d,
                                              depth, iota_bits, out, stream);
}

extern "C" const char* boxtree_torch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
