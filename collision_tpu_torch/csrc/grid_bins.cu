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
// key (cx gd + cy) gd + cz, the arithmetic rounded as bucket_sort.cuh
// says; the sort stable, so ids stay in id order within a cell.
//
// What bounds it on the H100. At 16M spheres, gd 61 and M 120: the
// centres and radii, 256 MB, read once; the bins, 63^3 * 120 * 32 B = 960
// MB, and the int64 ids in cell order, 128 MB, written once: 0.40 ms at
// 3.35 TB/s. The sort moves 16M 18-bit keys with 32-bit ids, three 8-bit
// digit passes of 128 MB read and 128 MB written each: 0.23 ms more.
//
// What the design does about it. Five kernels and cub's sort in stream
// order, nothing read back by the host (* marks bucket_sort.cuh's steps):
// bounds_partial_kernel*, bounds_final_kernel, keys_kernel, sort_pairs*
// on bits [0, bit_length(gd^3 - 1)) only (3 digit passes at gd 61 where a
// 64-bit key takes 8), bucket_starts_kernel* and fill_kernel, which
// writes every bin slot once, never filled first. Nothing the size of [n,
// 8] or an int64 key is materialised.
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

#include "bucket_sort.cuh"

namespace {

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

// One block: params[0..2] = lo, params[3..5] = the cell size s; *ok = 1.
// gd arrives as an argument: no constant from the host.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bounds_final_kernel(const T* __restrict__ partial, int blocks, int gd,
                        T* __restrict__ params, unsigned char* ok) {
  T v[NB];
  fold_partials(partial, blocks, v);
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

// A warp a padded cell writes the cell's M rows as one contiguous run, 16
// bytes a lane (two lanes a float row, four a double row): the first
// min(count, M) sorted spheres, their records gathered by id, then +inf
// rows; halo cells +inf only. It also writes the cell's ids (int64) at
// their sorted places and clears ok on overflow. starts null: no spheres.
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

// The bits a key can hold, at least 1.
int key_bits(int gd) {
  return std::max(
      1, bit_length(static_cast<unsigned long long>(gd) * gd * gd - 1));
}

// The workspace's parts, as byte offsets.
struct Layout : Workspace {
  long long partial, params, spheres, starts;
};

cudaError_t layout(long long n, int gd, int f64, Layout* l) {
  const long long cells = static_cast<long long>(gd) * gd * gd;
  l->partial = l->take(BOUNDS_BLOCKS * 8 * sizeof(double));
  l->params = l->take(8 * sizeof(double));
  const cudaError_t err = l->take_sort(n, key_bits(gd));
  l->spheres = l->take((f64 ? 32 : 16) * n);
  l->starts = l->take(4 * (cells + 1));
  return err;
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
    T* partial = carved<T>(work, l.partial);
    T* params = carved<T>(work, l.params);
    int* st = carved<int>(work, l.starts);
    spheres = carved<Sphere<T>>(work, l.spheres);
    const int blocks = bounds_partials(coords, radii, n, partial, stream);
    bounds_final_kernel<T><<<1, THREADS, 0, stream>>>(partial, blocks, gd,
                                                      params, ok);
    keys_kernel<T><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                     THREADS, 0, stream>>>(
        coords, radii, n, gd, params, carved<unsigned>(work, l.keys[0]),
        carved<unsigned>(work, l.ids[0]), spheres);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cub::DoubleBuffer<unsigned> dk, dv;
    err = l.sort_pairs(work, n, key_bits(gd), stream, &dk, &dv);
    if (err != cudaSuccess) return err;
    const unsigned cells = static_cast<unsigned>(gd) * gd * gd;
    // starts[c] = the first sorted index whose key is >= c, c in [0,
    // cells].
    bucket_starts(dk.Current(), n, cells + 1LL, 0, st, stream);
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
