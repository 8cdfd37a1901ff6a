// The steps the plan chains run on the card to bucket spheres by a
// 32-bit key, the slab plan (slab_plan.cu), the column plan
// (column_plan.cu) and the grid bins (grid_bins.cu): the bounds partials,
// the packed sphere record, the z quantizer and workspace layout of the
// two sweep plans, the stable sort on only the key's bits and each
// bucket's first sorted index. Each chain keeps its own scalars, keys and
// output passes. Every subtraction, addition and division is IEEE and
// rounded to nearest, stated by intrinsic rather than left to flags
// (built without --use_fast_math). In an unnamed namespace, like the
// chains' own code: each source that includes it compiles its own copy of
// the kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Bounds blocks at most: 8 a SM on 132 SMs, and a multiple of 3.
constexpr int BOUNDS_BLOCKS = 1056;
constexpr long long ALIGN = 256;

__device__ inline float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ inline T lesser(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ inline T greater(T a, T b) { return b > a ? b : a; }

template <typename T>
__device__ inline T pos_inf() { return T(__int_as_float(0x7f800000)); }

// A sphere's centre and radius, packed by a chain's keys kernel so that
// its gather by id reads one aligned 16- or 32-byte record where [n, 3]
// and [n] took two or three sectors.
template <typename T>
struct alignas(4 * sizeof(T)) Sphere {
  T x, y, z, r;
};

// The bounds' seven values: lo[3] (min), hi[3] (max), r_max (max).
constexpr int NB = 7;

template <typename T>
__device__ inline T fold(int k, T a, T b) {
  return k < 3 ? lesser(a, b) : greater(a, b);
}

// Folds v over the block; thread 0 holds the result.
template <typename T>
__device__ void block_fold(T (&v)[NB], T (*part)[NB]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NB; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] = fold(k, v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < NB; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w)
#pragma unroll
      for (int k = 0; k < NB; ++k) v[k] = fold(k, v[k], part[w][k]);
}

template <typename T>
__device__ inline void identities(T (&v)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) v[k] = k < 3 ? pos_inf<T>() : -pos_inf<T>();
}

// Folds the blocks' partials (bounds_partial_kernel's) into v; thread 0
// holds the result.
template <typename T>
__device__ void fold_partials(const T* __restrict__ partial, int blocks,
                              T (&v)[NB]) {
  __shared__ T part[WARPS][NB];
  identities(v);
  for (int b = threadIdx.x; b < blocks; b += THREADS)
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = fold(k, v[k], partial[b * 8 + k]);
  block_fold(v, part);
}

// partial[b * 8 + k]: block b's fold of value k, the min and max of each
// axis and the largest radius. gridDim.x is a multiple of 3, so thread g
// reads axis g % 3 of the flat [n, 3] centres at every stride, coalesced.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bounds_partial_kernel(const T* __restrict__ coords,
                          const T* __restrict__ radii, long long n,
                          T* __restrict__ partial) {
  __shared__ T part[WARPS][NB];
  const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const int axis = static_cast<int>(g % 3);
  T lo = pos_inf<T>(), hi = -pos_inf<T>(), r = -pos_inf<T>();
  for (long long j = g; j < 3 * n; j += stride) {
    const T c = coords[j];
    lo = lesser(lo, c);
    hi = greater(hi, c);
  }
  for (long long j = g; j < n; j += stride) r = greater(r, radii[j]);
  T v[NB];
  identities(v);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (a == axis) {
      v[a] = lo;
      v[3 + a] = hi;
    }
  v[6] = r;
  block_fold(v, part);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < NB; ++k) partial[blockIdx.x * 8 + k] = v[k];
}

// Launches bounds_partial_kernel on n >= 1 spheres into partial (8 values
// a block, BOUNDS_BLOCKS blocks at most); returns its block count.
template <typename T>
int bounds_partials(const T* coords, const T* radii, long long n, T* partial,
                    cudaStream_t stream) {
  const long long want = (3 * n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(
      std::min<long long>(BOUNDS_BLOCKS, (want + 2) / 3 * 3));
  bounds_partial_kernel<T><<<blocks, THREADS, 0, stream>>>(coords, radii, n,
                                                           partial);
  return blocks;
}

// The bits x takes: 0 for 0.
inline int bit_length(unsigned long long x) {
  return x ? 64 - __builtin_clzll(x) : 0;
}

// First index in [lo, hi) of the sorted keys at or above target, else hi.
template <typename I, typename K>
__device__ inline I lower_bound(const unsigned* __restrict__ keys, I lo, I hi,
                                K target) {
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// starts[b] = the first sorted index whose key is >= b << shift, b in [0,
// buckets): each bucket's first sorted index.
__global__ void __launch_bounds__(THREADS)
    bucket_starts_kernel(const unsigned* __restrict__ keys, long long n,
                         long long buckets, int shift,
                         int* __restrict__ starts) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (b >= buckets) return;
  starts[b] = static_cast<int>(lower_bound<long long>(
      keys, 0, n, static_cast<unsigned long long>(b) << shift));
}

// Launches bucket_starts_kernel on the n sorted keys.
inline void bucket_starts(const unsigned* keys, long long n,
                          long long buckets, int shift, int* starts,
                          cudaStream_t stream) {
  bucket_starts_kernel<<<static_cast<unsigned>((buckets + THREADS - 1) /
                                               THREADS),
                         THREADS, 0, stream>>>(keys, n, buckets, shift,
                                               starts);
}

// min(trunc(clamp((z - lo) * scale, 0, 2^32)), zmax): the plain plans'
// columns._quantize, whose integer clamp keeps a top sphere out of the
// bucket bits of the key.
__device__ inline unsigned quantize(float z, float lo, float scale,
                                    unsigned zmax) {
  const float q = __fmul_rn(__fsub_rn(z, lo), scale);
  const unsigned long long t =
      __float2ull_rz(fminf(fmaxf(q, 0.0f), 4294967296.0f));
  return t < zmax ? static_cast<unsigned>(t) : zmax;
}

template <typename P>
P* carved(char* work, long long offset) {
  return reinterpret_cast<P*>(work + offset);
}

// A workspace carved into ALIGN-aligned parts, end its size in bytes, with
// the sort's parts as byte offsets: the key and id double buffers and
// cub's temporary storage. A chain's Layout is one, with its own parts.
struct Workspace {
  long long end = 0, keys[2], ids[2], temp;
  size_t temp_bytes;
  long long take(long long bytes) {
    const long long at = end;
    end += (bytes + ALIGN - 1) / ALIGN * ALIGN;
    return at;
  }

  // Takes the key and id buffers of n pairs and the temporary storage cub
  // asks for to sort them on bits [0, bits); none for no pairs.
  cudaError_t take_sort(long long n, int bits) {
    for (int b = 0; b < 2; ++b) keys[b] = take(4 * n);
    for (int b = 0; b < 2; ++b) ids[b] = take(4 * n);
    temp_bytes = 0;
    if (n > 0) {
      cub::DoubleBuffer<unsigned> k(nullptr, nullptr), v(nullptr, nullptr);
      const cudaError_t err = cub::DeviceRadixSort::SortPairs(
          nullptr, temp_bytes, k, v, static_cast<int>(n), 0, bits);
      if (err != cudaSuccess) return err;
    }
    temp = take(static_cast<long long>(temp_bytes));
    return cudaSuccess;
  }

  // Sorts the n pairs in buffers 0 of the workspace stably on key bits [0,
  // bits) with cub's LSD radix sort; the sorted keys and ids are then
  // k->Current() and v->Current().
  cudaError_t sort_pairs(char* work, long long n, int bits,
                         cudaStream_t stream, cub::DoubleBuffer<unsigned>* k,
                         cub::DoubleBuffer<unsigned>* v) const {
    *k = cub::DoubleBuffer<unsigned>(carved<unsigned>(work, keys[0]),
                                     carved<unsigned>(work, keys[1]));
    *v = cub::DoubleBuffer<unsigned>(carved<unsigned>(work, ids[0]),
                                     carved<unsigned>(work, ids[1]));
    size_t bytes = temp_bytes;
    return cub::DeviceRadixSort::SortPairs(work + temp, bytes, *k, *v,
                                           static_cast<int>(n), 0, bits,
                                           stream);
  }
};

// The workspace of a sweep plan's chain (slab_plan.cu, column_plan.cu), as
// byte offsets: the bounds partials, the chain's scalars S, the sort's
// parts for n keys of `bits` bits and the n packed float spheres.
template <typename S>
struct PlanLayout : Workspace {
  long long partial, scalars, spheres;
  cudaError_t carve(long long n, int bits) {
    partial = take(BOUNDS_BLOCKS * 8 * sizeof(float));
    scalars = take(sizeof(S));
    const cudaError_t err = take_sort(n, bits);
    spheres = take(sizeof(Sphere<float>) * n);
    return err;
  }
};

}  // namespace
