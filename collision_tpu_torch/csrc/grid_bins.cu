// The grid engine's bins, built on the card in one chain: the scene's
// bounds and cell size, a cell key a sphere, a stable sort on the key's
// bits, and one pass that writes every bin slot.
//
// Replaces no TPU kernel: the JAX package builds the bins with XLA ops
// (collision_tpu/grid.py: build_grid, a stable sort and a row scatter; its
// TPU "compact" branch a Pallas compaction and a gather). The port's torch
// ops for the same (grid.build_grid_plain, the CPU path and the reference
// of the card tests) took ~90 device ops, a 960 MB fill, an [n, 8] cat, a
// 64-bit sort, a searchsorted and an index_put_, and two host syncs a frame.
//
// The bins are T[gp, gp, gp, M, 8], gp = gd + 2, T float or double: cell
// (x, y, z) of the grid is padded cell (x+1, y+1, z+1), the border cells
// are +inf. A sphere's row: c - r on three axes, the id's bits (int32 for
// float, int64 for double), c + r, then 0; empty slots are +inf rows. A
// cell keeps its first M spheres in id order; ok is cleared when a cell
// holds more. Bit for bit the plain path's bins: the cell size is s =
// max(2 r_max, (hi - lo) / gd) on each axis, 1 where not positive; a
// sphere's cell is clamp(trunc((c - lo) / s), 0, gd - 1) on each axis; the
// key (cx gd + cy) gd + cz; every subtraction, addition and division IEEE
// and rounded to nearest, stated by intrinsic rather than left to flags
// (built without --use_fast_math); the sort stable, so ids stay in id
// order within a cell.
//
// What bounds it on the H100. At 16M spheres, gd 61 and M 120: the
// centres and radii, 256 MB, read once; the bins, 63^3 * 120 * 32 B = 960
// MB, and the int64 ids in cell order, 128 MB, written once: 0.40 ms at
// 3.35 TB/s. The sort moves 16M 18-bit keys with 32-bit ids, three 8-bit
// digit passes of 128 MB read and 128 MB written each: 0.23 ms more.
//
// What the design does about it. Five kernels and cub's sort in stream
// order, nothing read back by the host:
// 1. bounds_partial_kernel: a fixed grid of blocks, a multiple of 3 of
//    them, so each thread reads one axis of the flat [n, 3] centres,
//    coalesced; each block writes the min and max of each axis and the
//    largest radius.
// 2. bounds_final_kernel: one block folds the partials into the cell size
//    and sets ok. gd arrives as an argument: no constant from the host.
// 3. keys_kernel: a uint32 key and the uint32 id of each sphere, and its
//    centre and radius packed into one aligned 16-byte (float) or 32-byte
//    (double) record, so the fill's gather by id reads one sector a
//    sphere where the [n, 3] centres and the radii took two or three.
// 4. cub::DeviceRadixSort::SortPairs (LSD, stable) on bits [0,
//    bit_length(gd^3 - 1)) only: 3 digit passes at gd 61 where a 64-bit
//    key takes 8, the keys and ids in double buffers of the workspace.
// 5. starts_kernel: each cell's first sorted index, a thread and a binary
//    search a cell (gd^3 + 1 of them, all at once).
// 6. fill_kernel: a warp a padded cell writes the cell's M rows as one
//    contiguous run, 16 bytes a lane (two lanes a float row, four a
//    double row): the first min(count, M) sorted spheres, their packed
//    records gathered by id, then +inf rows; halo cells +inf only. It also
//    writes the cell's ids, widened to int64, and clears ok on overflow.
// So the bins are written once and never filled first, and nothing the
// size of [n, 8] or an int64 key is materialised.
//
// On an H100 at 16M spheres the chain takes 1.66-1.68 ms of device time
// (the torch ops it replaces: 11.77): the fill 0.91, cub's sort 0.42 (its
// three digit passes 0.37), keys 0.21, bounds 0.09, starts 0.03. The fill
// is bound by its gather, 16M random 16-byte reads: its writes alone, 1.1
// GB, take ~0.35 ms. Gathering the [n, 3] centres and the radii in place
// of the packed records took 1.40 ms in the fill (keys 0.11); writing the
// rows from a thread a sorted sphere, with a second pass for the +inf
// slots, 0.74 + 0.15 ms (1.5% less in all, for one launch more);
// streaming stores (st.global.cs) for the bins changed nothing.

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
__device__ inline T pos_inf();
template <>
__device__ inline float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ inline double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// A bin row as 16-byte stores: LANES lanes a row, lane q its words
// [q * 16 / sizeof(T), (q + 1) * 16 / sizeof(T)).
template <typename T>
struct Row;

template <>
struct Row<float> {
  using Vec = float4;
  static constexpr int LANES = 2;
  static __device__ Vec inf() {
    const float i = pos_inf<float>();
    return make_float4(i, i, i, i);
  }
  static __device__ Vec part(int q, float x, float y, float z, float r,
                             unsigned id) {
    if (q == 0)
      return make_float4(sub_rn(x, r), sub_rn(y, r), sub_rn(z, r),
                         __int_as_float(static_cast<int>(id)));
    return make_float4(add_rn(x, r), add_rn(y, r), add_rn(z, r), 0.0f);
  }
};

template <>
struct Row<double> {
  using Vec = double2;
  static constexpr int LANES = 4;
  static __device__ Vec inf() {
    const double i = pos_inf<double>();
    return make_double2(i, i);
  }
  static __device__ Vec part(int q, double x, double y, double z, double r,
                             unsigned id) {
    switch (q) {
      case 0: return make_double2(sub_rn(x, r), sub_rn(y, r));
      case 1:
        return make_double2(sub_rn(z, r),
                            __longlong_as_double(static_cast<long long>(id)));
      case 2: return make_double2(add_rn(x, r), add_rn(y, r));
      default: return make_double2(add_rn(z, r), 0.0);
    }
  }
};

// A sphere's centre and radius, one aligned 16- or 32-byte load.
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

// partial[b * 8 + k]: block b's fold of value k. gridDim.x is a multiple
// of 3, so thread g reads axis g % 3 of the flat centres at every stride.
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

// params[0..2] = lo, params[3..5] = the cell size s; *ok = 1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bounds_final_kernel(const T* __restrict__ partial, int blocks, int gd,
                        T* __restrict__ params, unsigned char* ok) {
  __shared__ T part[WARPS][NB];
  T v[NB];
  identities(v);
  for (int b = threadIdx.x; b < blocks; b += THREADS)
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = fold(k, v[k], partial[b * 8 + k]);
  block_fold(v, part);
  if (threadIdx.x != 0) return;
  const T two_r = T(2) * v[6];
  for (int a = 0; a < 3; ++a) {
    T s = greater(two_r, div_rn(sub_rn(v[3 + a], v[a]), T(gd)));
    params[a] = v[a];
    params[3 + a] = s > T(0) ? s : T(1);
  }
  *ok = 1;
}

// Each sphere's key, its id, and its centre and radius packed for the
// fill's gather.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    keys_kernel(const T* __restrict__ coords, const T* __restrict__ radii,
                long long n, int gd, const T* __restrict__ params,
                unsigned* __restrict__ keys, unsigned* __restrict__ ids,
                Sphere<T>* __restrict__ spheres) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  T c[3];
  unsigned key = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = coords[3 * i + a];
    const T q = div_rn(sub_rn(c[a], params[a]), params[3 + a]);
    const int cell = min(max(static_cast<int>(q), 0), gd - 1);
    key = key * static_cast<unsigned>(gd) + static_cast<unsigned>(cell);
  }
  keys[i] = key;
  ids[i] = static_cast<unsigned>(i);
  spheres[i] = Sphere<T>{c[0], c[1], c[2], radii[i]};
}

// starts[c] = the first sorted index whose key is >= c, c in [0, cells].
__global__ void __launch_bounds__(THREADS)
    starts_kernel(const unsigned* __restrict__ keys, int n, unsigned cells,
                  int* __restrict__ starts) {
  const unsigned c = blockIdx.x * THREADS + threadIdx.x;
  if (c > cells) return;
  unsigned lo = 0, hi = static_cast<unsigned>(n);
  while (lo < hi) {
    const unsigned mid = (lo + hi) >> 1;
    if (keys[mid] < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  starts[c] = static_cast<int>(lo);
}

// A warp a padded cell: its M rows, its ids (int64) at their sorted
// places, ok cleared on overflow. starts null: no spheres.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fill_kernel(const Sphere<T>* __restrict__ spheres,
                const unsigned* __restrict__ sorted_ids,
                const int* __restrict__ starts, int gd, int M,
                typename Row<T>::Vec* __restrict__ bins,
                long long* __restrict__ ids, unsigned char* ok) {
  constexpr int LANES = Row<T>::LANES;
  const int lane = threadIdx.x & 31;
  const long long gp = gd + 2;
  const long long cell =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (cell >= gp * gp * gp) return;
  const int px = static_cast<int>(cell / (gp * gp));
  const int py = static_cast<int>(cell / gp % gp);
  const int pz = static_cast<int>(cell % gp);
  int start = 0, live = 0;
  if (starts && px >= 1 && px <= gd && py >= 1 && py <= gd && pz >= 1 &&
      pz <= gd) {
    const int key = ((px - 1) * gd + py - 1) * gd + pz - 1;
    start = starts[key];
    const int count = starts[key + 1] - start;
    for (int k = lane; k < count; k += 32)
      ids[start + k] = static_cast<long long>(sorted_ids[start + k]);
    if (count > M && lane == 0) *ok = 0;
    live = min(count, M);
  }
  typename Row<T>::Vec* out = bins + cell * M * LANES;
  const int q = lane % LANES;
#pragma unroll 4
  for (int row = lane / LANES; row < M; row += 32 / LANES) {
    typename Row<T>::Vec v = Row<T>::inf();
    if (row < live) {
      const unsigned id = sorted_ids[start + row];
      const Sphere<T> b = spheres[id];
      v = Row<T>::part(q, b.x, b.y, b.z, b.r, id);
    }
    out[static_cast<long long>(row) * LANES + q] = v;
  }
}

int key_bits(int gd) {
  const unsigned long long top =
      static_cast<unsigned long long>(gd) * gd * gd - 1;
  int bits = 1;
  while (bits < 64 && (top >> bits)) ++bits;
  return bits;
}

// The workspace's parts, as byte offsets, and cub's temp storage size.
struct Layout {
  long long partial, params, keys[2], ids[2], spheres, starts, temp, end;
  size_t temp_bytes;
};

long long align_up(long long x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }

cudaError_t layout(long long n, int gd, int f64, Layout* l) {
  const long long cells = static_cast<long long>(gd) * gd * gd;
  long long off = 0;
  auto take = [&off](long long bytes) {
    const long long at = off;
    off += align_up(bytes);
    return at;
  };
  l->partial = take(BOUNDS_BLOCKS * 8 * sizeof(double));
  l->params = take(8 * sizeof(double));
  for (int b = 0; b < 2; ++b) l->keys[b] = take(4 * n);
  for (int b = 0; b < 2; ++b) l->ids[b] = take(4 * n);
  l->spheres = take((f64 ? 32 : 16) * n);
  l->starts = take(4 * (cells + 1));
  l->temp_bytes = 0;
  if (n > 0) {
    cub::DoubleBuffer<unsigned> keys(nullptr, nullptr), ids(nullptr, nullptr);
    const cudaError_t err = cub::DeviceRadixSort::SortPairs(
        nullptr, l->temp_bytes, keys, ids, static_cast<int>(n), 0,
        key_bits(gd));
    if (err != cudaSuccess) return err;
  }
  l->temp = take(static_cast<long long>(l->temp_bytes));
  l->end = off;
  return cudaSuccess;
}

bool valid(long long n, int gd, int M) {
  if (gd < 1 || M < 1 || n < 0 || n >= (1LL << 31)) return false;
  const long long gp = gd + 2LL;
  return gp * gp * gp < (1LL << 31);
}

template <typename T>
cudaError_t chain(const T* coords, const T* radii, long long n, int gd,
                  int M, char* work, const Layout& l, void* bins,
                  long long* ids, unsigned char* ok, cudaStream_t stream) {
  const long long gp = gd + 2LL;
  const int* starts = nullptr;
  const unsigned* sorted_ids = nullptr;
  Sphere<T>* spheres = nullptr;
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(ok, 1, 1, stream);
    if (err != cudaSuccess) return err;
  } else {
    T* partial = reinterpret_cast<T*>(work + l.partial);
    T* params = reinterpret_cast<T*>(work + l.params);
    unsigned* keys[2] = {reinterpret_cast<unsigned*>(work + l.keys[0]),
                         reinterpret_cast<unsigned*>(work + l.keys[1])};
    unsigned* idb[2] = {reinterpret_cast<unsigned*>(work + l.ids[0]),
                        reinterpret_cast<unsigned*>(work + l.ids[1])};
    int* st = reinterpret_cast<int*>(work + l.starts);
    spheres = reinterpret_cast<Sphere<T>*>(work + l.spheres);
    const long long want = (3 * n + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(
        std::min<long long>(BOUNDS_BLOCKS, (want + 2) / 3 * 3));
    bounds_partial_kernel<T><<<blocks, THREADS, 0, stream>>>(coords, radii, n,
                                                             partial);
    bounds_final_kernel<T><<<1, THREADS, 0, stream>>>(partial, blocks, gd,
                                                      params, ok);
    keys_kernel<T><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                     THREADS, 0, stream>>>(coords, radii, n, gd, params,
                                           keys[0], idb[0], spheres);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cub::DoubleBuffer<unsigned> dk(keys[0], keys[1]), dv(idb[0], idb[1]);
    size_t temp_bytes = l.temp_bytes;
    err = cub::DeviceRadixSort::SortPairs(work + l.temp, temp_bytes, dk, dv,
                                          static_cast<int>(n), 0, key_bits(gd),
                                          stream);
    if (err != cudaSuccess) return err;
    const unsigned cells = static_cast<unsigned>(gd) * gd * gd;
    starts_kernel<<<(cells + THREADS) / THREADS, THREADS, 0, stream>>>(
        dk.Current(), static_cast<int>(n), cells, st);
    starts = st;
    sorted_ids = dv.Current();
  }
  const long long padded = gp * gp * gp;
  fill_kernel<T><<<static_cast<unsigned>((padded + WARPS - 1) / WARPS),
                   THREADS, 0, stream>>>(
      spheres, sorted_ids, starts, gd, M,
      static_cast<typename Row<T>::Vec*>(bins), ids, ok);
  return cudaGetLastError();
}

}  // namespace

// The workspace bytes grid_bins_launch takes for n spheres at grid_dim gd
// (double when f64, else float), into *bytes.
extern "C" int grid_bins_workspace(long long n, int gd, int f64,
                                   long long* bytes) {
  if (!bytes || !valid(n, gd, 1)) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = layout(n, gd, f64, &l);
  *bytes = l.end;
  return static_cast<int>(err);
}

// The bins of n spheres (coords T[n, 3], radii T[n], T double when f64
// else float) into bins T[gd+2, gd+2, gd+2, M, 8], the ids in cell order
// into ids int64[n], ok (one byte) 1 unless a cell holds more than M;
// work: work_bytes of device memory, at least grid_bins_workspace's.
extern "C" int grid_bins_launch(const void* coords, const void* radii,
                                long long n, int gd, int M, int f64,
                                void* work, long long work_bytes, void* bins,
                                long long* ids, unsigned char* ok,
                                void* stream) {
  if (!valid(n, gd, M) || !bins || !ok || !work ||
      (n > 0 && (!coords || !radii || !ids)) ||
      (reinterpret_cast<uintptr_t>(bins) & 15) ||
      (reinterpret_cast<uintptr_t>(work) & (ALIGN - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  cudaError_t err = layout(n, gd, f64, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_bytes < l.end) return static_cast<int>(cudaErrorInvalidValue);
  char* w = static_cast<char*>(work);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    err = chain(static_cast<const double*>(coords),
                static_cast<const double*>(radii), n, gd, M, w, l, bins, ids,
                ok, s);
  else
    err = chain(static_cast<const float*>(coords),
                static_cast<const float*>(radii), n, gd, M, w, l, bins, ids,
                ok, s);
  return static_cast<int>(err);
}
