// The slab engine's plan, built on the card in one chain: the scene's
// bounds and the plan's scalars, a 32-bit key a sphere, a stable sort on
// the key's bits, one pass that writes the sorted stream, and the slab
// starts and window tables.
//
// Replaces no TPU kernel: the JAX package builds the plan with XLA ops
// (collision_tpu/slabs.py: plan_slabs). The port's torch ops for the same
// (slabs.plan_slabs_plain, the CPU path and the reference of the card
// tests) took ~270 device ops, a sort of int64 keys, gathers, an [8, n]
// stack and its transposed copy, a [gx, mc, 64] gather for the chunks' z
// ranges and six host syncs a frame.
//
// The plan, bit for bit the plain path's: spheres sort stably by key
// col << zbits | quantize(z), col = clamp(trunc((x - lo_x) / sx), 0, gx -
// 1), sx = max(2 r_max, (hi_x - lo_x) / gx), 1 where not positive;
// quantize(z) = min(trunc(clamp((z - lo_z) * zscale, 0, 2^32)), zmax),
// zscale = zmax / zext, zext the z extent, 1 where not positive. The
// stream is [rows, 8, 128] float: sorted sphere p is lane p % 128 of row
// p / 128, channels c - r on three axes, c + r, the id's bits and the
// slab index as a float; +inf past n. starts[b] is the first sorted index
// of slab b, b in [0, gx + 2). Chunk k of slab c holds sorted spheres
// [starts[c] + 64k, min(starts[c] + 64k + 64, starts[c + 1])); its z range
// is the min of their zlo and the max of their zhi, its thresholds that
// range widened by r_max, clamped to [lo_z, max(lo_z + zext, hi_z)] and
// quantized; its window in slab c + dx (dx 0, 1) is the sorted range of
// keys [(c + dx) << zbits | qlo, ((c + dx) << zbits) + qhi + 1), the self
// slab's clipped at the chunk start; an empty chunk's windows are (0, 0).
// Every subtraction, addition, product and division is IEEE and rounded
// to nearest, stated by intrinsic rather than left to flags (built
// without --use_fast_math), in the plain path's order.
//
// What bounds it on the H100. At 16M spheres and gx 1000: the centres and
// radii, 256 MB, read once; the keys, ids and packed records, 384 MB,
// written once and read once; the stream, 538 MB, written once: 0.47 ms
// at 3.35 TB/s. The sort moves 16M 32-bit keys with 32-bit ids, four
// 8-bit digit passes of 128 MB read and 128 MB written each: 0.31 ms
// more. The tables read the stream's two z channels and search the keys.
//
// What the design does about it. Six kernels and cub's sort in stream
// order, nothing read back by the host:
// 1. bounds_kernel: a fixed grid of blocks, a multiple of 3 of them, so
//    each thread reads one axis of the flat [n, 3] centres, coalesced;
//    each block writes the min and max of each axis and the largest
//    radius.
// 2. scalars_kernel: one block folds the partials into the plan's scalars
//    and diag_thr, zeroes the maxima and sets ok. gx, zbits and the
//    capacities arrive as arguments: no constant from the host.
// 3. keys_kernel: a uint32 key and the uint32 id of each sphere, and its
//    centre and radius packed into one aligned 16-byte record, so the
//    stream pass's gather by id reads one sector a sphere.
// 4. cub::DeviceRadixSort::SortPairs (LSD, stable) on bits [0, zbits +
//    bit_length(gx - 1)) only, the bits a key can hold: 4 digit passes at
//    gx 1000 where an int64 key takes 8.
// 5. starts_kernel: each slab's first sorted index, a thread and a binary
//    search a slab.
// 6. stream_kernel: a thread a stream lane writes its eight channels, so a
//    warp's stores to a channel are 128 contiguous bytes; the lanes past n
//    are +inf. The stream is written once and never filled first.
// 7. tables_kernel: a warp takes 8 chunks at a time. It takes each chunk's
//    z range from the stream's zlo and zhi channels, two lanes a thread,
//    then runs the 8 chunks' 32 threshold searches at once, a binary
//    search a lane inside the slab's sorted range; the self slab's first
//    search is one load where the window starts at the chunk start, as it
//    does wherever no radius is negative. A lane a chunk writes its two
//    windows as one 8-byte store. Chunk 0 of a slab also gives its size
//    and rows for max_col, max_slab_rows and ok; a block folds its maxima
//    and adds them with one atomicMax each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/device/device_radix_sort.cuh>

#include "stream.cuh"

namespace {

using stream::CHUNK;
using stream::LANE;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Bounds blocks at most: 8 a SM on 132 SMs, and a multiple of 3; the
// tables kernel's blocks at most, the same.
constexpr int BOUNDS_BLOCKS = 1056;
constexpr int TABLE_BLOCKS = 1056;
constexpr int CHANNELS = 8;
// Chunks a warp of the tables kernel takes at a time: one search a lane.
constexpr int GROUP = 8;
constexpr long long ALIGN = 256;

__device__ inline float lesser(float a, float b) { return b < a ? b : a; }
__device__ inline float greater(float a, float b) { return b > a ? b : a; }
__device__ inline float pos_inf() { return __int_as_float(0x7f800000); }

// The plan's scalars, made on the card by scalars_kernel.
struct Scalars {
  float lo_x, lo_z, sx, zscale, zhi_scene, r_max;
};

// A sphere's centre and radius, one aligned 16-byte load.
struct alignas(16) Sphere {
  float x, y, z, r;
};

// min(trunc(clamp((z - lo) * scale, 0, 2^32)), zmax): the plain path's
// _quantize, whose integer clamp keeps a top sphere out of the slab bits.
__device__ inline unsigned quantize(float z, float lo, float scale,
                                    unsigned zmax) {
  const float q = __fmul_rn(__fsub_rn(z, lo), scale);
  const unsigned long long t =
      __float2ull_rz(fminf(fmaxf(q, 0.0f), 4294967296.0f));
  return t < zmax ? static_cast<unsigned>(t) : zmax;
}

// The bounds' seven values: lo[3] (min), hi[3] (max), r_max (max).
constexpr int NB = 7;

__device__ inline float fold(int k, float a, float b) {
  return k < 3 ? lesser(a, b) : greater(a, b);
}

// Folds v over the block; thread 0 holds the result.
__device__ void block_fold(float (&v)[NB], float (*part)[NB]) {
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

__device__ inline void identities(float (&v)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) v[k] = k < 3 ? pos_inf() : -pos_inf();
}

// partial[b * 8 + k]: block b's fold of value k. gridDim.x is a multiple
// of 3, so thread g reads axis g % 3 of the flat centres at every stride.
__global__ void __launch_bounds__(THREADS)
    bounds_kernel(const float* __restrict__ coords,
                  const float* __restrict__ radii, long long n,
                  float* __restrict__ partial) {
  __shared__ float part[WARPS][NB];
  const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const int axis = static_cast<int>(g % 3);
  float lo = pos_inf(), hi = -pos_inf(), r = -pos_inf();
  for (long long j = g; j < 3 * n; j += stride) {
    const float c = coords[j];
    lo = lesser(lo, c);
    hi = greater(hi, c);
  }
  for (long long j = g; j < n; j += stride) r = greater(r, radii[j]);
  float v[NB];
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

// The plan's scalars and diag_thr from the partials; maxima[0..2] = 0,
// *ok = 1.
__global__ void __launch_bounds__(THREADS)
    scalars_kernel(const float* __restrict__ partial, int blocks, int gx,
                   int zbits, Scalars* __restrict__ s,
                   float* __restrict__ diag_thr, int* __restrict__ maxima,
                   unsigned char* ok) {
  __shared__ float part[WARPS][NB];
  float v[NB];
  identities(v);
  for (int b = threadIdx.x; b < blocks; b += THREADS)
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = fold(k, v[k], partial[b * 8 + k]);
  block_fold(v, part);
  if (threadIdx.x != 0) return;
  const float lo_x = v[0], lo_z = v[2], hi_x = v[3], hi_z = v[5];
  const float r_max = v[6];
  float sx = greater(__fmul_rn(2.0f, r_max),
                     __fdiv_rn(__fsub_rn(hi_x, lo_x), static_cast<float>(gx)));
  sx = sx > 0.0f ? sx : 1.0f;
  const float ext_z = __fsub_rn(hi_z, lo_z);
  const float zext = ext_z > 0.0f ? ext_z : 1.0f;
  const float zscale = __fdiv_rn(__uint2float_rn((1u << zbits) - 1), zext);
  *s = Scalars{lo_x, lo_z, sx, zscale,
               greater(__fadd_rn(lo_z, zext), hi_z), r_max};
  // The plain path's association: (r_max + 1 / zscale) + ((|lo_z| + zext)
  // + r_max) * 2^-20.
  diag_thr[0] = __fadd_rn(
      __fadd_rn(r_max, __fdiv_rn(1.0f, zscale)),
      __fmul_rn(__fadd_rn(__fadd_rn(fabsf(lo_z), zext), r_max), 0x1p-20f));
  maxima[0] = maxima[1] = maxima[2] = 0;
  *ok = 1;
}

// Each sphere's key, its id, and its centre and radius packed for the
// stream pass's gather.
__global__ void __launch_bounds__(THREADS)
    keys_kernel(const float* __restrict__ coords,
                const float* __restrict__ radii, long long n, int gx,
                int zbits, const Scalars* __restrict__ s,
                unsigned* __restrict__ keys, unsigned* __restrict__ ids,
                Sphere* __restrict__ spheres) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  const Scalars p = *s;
  const float x = coords[3 * i], y = coords[3 * i + 1], z = coords[3 * i + 2];
  const int col = min(
      max(__float2int_rz(__fdiv_rn(__fsub_rn(x, p.lo_x), p.sx)), 0), gx - 1);
  keys[i] = (static_cast<unsigned>(col) << zbits) |
            quantize(z, p.lo_z, p.zscale, (1u << zbits) - 1);
  ids[i] = static_cast<unsigned>(i);
  spheres[i] = Sphere{x, y, z, radii[i]};
}

// First index in [lo, hi) of the sorted keys at or above target, else hi.
__device__ inline long long lower_bound(const unsigned* __restrict__ keys,
                                        long long lo, long long hi,
                                        unsigned long long target) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// starts[b] = the first sorted index of slab b, b in [0, gx + 2).
__global__ void __launch_bounds__(THREADS)
    starts_kernel(const unsigned* __restrict__ keys, long long n, int gx,
                  int zbits, int* __restrict__ starts) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= gx + 2) return;
  starts[b] = static_cast<int>(
      lower_bound(keys, 0, n, static_cast<unsigned long long>(b) << zbits));
}

// Lane p of the stream, p in [0, rows * 128): sorted sphere p's eight
// channels, or +inf past n.
__global__ void __launch_bounds__(THREADS)
    stream_kernel(const Sphere* __restrict__ spheres,
                  const unsigned* __restrict__ keys,
                  const unsigned* __restrict__ ids, long long n,
                  long long lanes, int zbits, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (p >= lanes) return;
  float v[CHANNELS];
  if (p < n) {
    const unsigned id = ids[p];
    const Sphere b = spheres[id];
    v[0] = __fsub_rn(b.x, b.r);
    v[1] = __fsub_rn(b.y, b.r);
    v[2] = __fsub_rn(b.z, b.r);
    v[3] = __fadd_rn(b.x, b.r);
    v[4] = __fadd_rn(b.y, b.r);
    v[5] = __fadd_rn(b.z, b.r);
    v[6] = __int_as_float(static_cast<int>(id));
    v[7] = __uint2float_rn(keys[p] >> zbits);
  } else {
#pragma unroll
    for (int c = 0; c < CHANNELS; ++c) v[c] = pos_inf();
  }
  float* at = out + (p / LANE) * (CHANNELS * LANE) + p % LANE;
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) at[c * LANE] = v[c];
}

// A warp takes GROUP chunks t = c * mc + k at a time: their z ranges one
// after the other, then their 4 * GROUP threshold searches at once, lane
// 4j + e the search e of chunk j; lane 4j writes chunk j's windows into w0
// / wcap [gx, mc, 2] as one 8-byte store each. Chunk 0 of each slab also
// gives its size and rows. maxima: rows_rolled, max_col, max_slab_rows.
__global__ void __launch_bounds__(THREADS)
    tables_kernel(const float* __restrict__ stream,
                  const unsigned* __restrict__ keys,
                  const int* __restrict__ starts,
                  const Scalars* __restrict__ s, int gx, int mc, int zbits,
                  int col_capacity, int slab_rows, int2* __restrict__ w0,
                  int2* __restrict__ wcap, int* __restrict__ maxima,
                  unsigned char* ok) {
  __shared__ int part[WARPS][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = lane >> 2, e = lane & 3;
  const Scalars p = *s;
  const unsigned zmax = (1u << zbits) - 1;
  const long long chunks = static_cast<long long>(gx) * mc;
  int most[3] = {0, 0, 0};
  for (long long t0 = (static_cast<long long>(blockIdx.x) * WARPS + warp) *
                      GROUP;
       t0 < chunks; t0 += static_cast<long long>(gridDim.x) * WARPS * GROUP) {
    // The z range of chunk t0 + mine, from the warp's pass over each chunk.
    float lo = pos_inf(), hi = -pos_inf();
    for (int j = 0; j < GROUP && t0 + j < chunks; ++j) {
      const int c = static_cast<int>((t0 + j) / mc);
      const int k = static_cast<int>((t0 + j) % mc);
      const long long s0 = starts[c], s1 = starts[c + 1];
      if (k == 0) {
        const int size = static_cast<int>(s1 - s0);
        const int rows = static_cast<int>((s1 + LANE - 1) / LANE - s0 / LANE);
        most[1] = max(most[1], size);
        most[2] = max(most[2], rows);
        if (lane == 0 && (size > col_capacity || rows + 2 > slab_rows))
          *ok = 0;
      }
      const long long g0 = s0 + static_cast<long long>(CHUNK) * k;
      float zlo = pos_inf(), zhi = -pos_inf();
#pragma unroll
      for (int h = 0; h < CHUNK; h += 32)
        if (g0 + h + lane < s1) {
          zlo = lesser(zlo, stream::comp(stream, g0 + h + lane, 2));
          zhi = greater(zhi, stream::comp(stream, g0 + h + lane, 5));
        }
      for (int off = 16; off > 0; off >>= 1) {
        zlo = lesser(zlo, __shfl_xor_sync(0xffffffffu, zlo, off));
        zhi = greater(zhi, __shfl_xor_sync(0xffffffffu, zhi, off));
      }
      if (j == mine) {
        lo = zlo;
        hi = zhi;
      }
    }
    const long long t = t0 + mine;
    const int c = static_cast<int>(min(t, chunks - 1) / mc);
    const int k = static_cast<int>(min(t, chunks - 1) % mc);
    const long long g0 = starts[c] + static_cast<long long>(CHUNK) * k;
    const bool live = t < chunks && g0 < starts[c + 1];
    // Search e = 2 dx + f: the threshold of slab c + dx, f 0 its first key
    // (qlo), f 1 its end (qhi + 1), which lies in that slab's sorted range.
    long long at = 0;
    if (live) {
      const unsigned qlo = quantize(
          lesser(greater(__fsub_rn(lo, p.r_max), p.lo_z), p.zhi_scene),
          p.lo_z, p.zscale, zmax);
      const unsigned qhi = quantize(
          lesser(greater(__fadd_rn(hi, p.r_max), p.lo_z), p.zhi_scene),
          p.lo_z, p.zscale, zmax);
      const int b = c + (e >> 1);
      const unsigned long long target =
          (static_cast<unsigned long long>(b) << zbits) +
          ((e & 1) ? static_cast<unsigned long long>(qhi) + 1 : qlo);
      if (e == 0)
        // The self slab's window, clipped at the chunk start (j > i),
        // starts past it only where the chunk's first key is below the
        // threshold.
        at = keys[g0] >= target ? g0
                                : lower_bound(keys, g0 + 1, starts[c + 1],
                                              target);
      else
        at = lower_bound(keys, starts[b], starts[b + 1], target);
    }
    const long long end_a = __shfl_down_sync(0xffffffffu, at, 1);
    const long long wb = __shfl_down_sync(0xffffffffu, at, 2);
    const long long end_b = __shfl_down_sync(0xffffffffu, at, 3);
    if (e == 0 && t < chunks) {
      const long long ca = live ? max(end_a - at, 0LL) : 0;
      const long long cb = live ? max(end_b - wb, 0LL) : 0;
      w0[t] = make_int2(static_cast<int>(at), static_cast<int>(live ? wb : 0));
      wcap[t] = make_int2(static_cast<int>(ca), static_cast<int>(cb));
      most[0] = max(most[0], static_cast<int>((max(ca, cb) + LANE - 1) / LANE));
    }
  }
  most[0] = __reduce_max_sync(0xffffffffu, most[0]);
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < 3; ++m) part[warp][m] = most[m];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < WARPS; ++w)
#pragma unroll
    for (int m = 0; m < 3; ++m) most[m] = max(most[m], part[w][m]);
#pragma unroll
  for (int m = 0; m < 3; ++m)
    if (most[m] > 0) atomicMax(maxima + m, most[m]);
}

// The bits a key can hold: zbits of z and bit_length(gx - 1) of slab.
int key_bits(int gx, int zbits) {
  int bits = zbits;
  for (unsigned top = static_cast<unsigned>(gx - 1); top; top >>= 1) ++bits;
  return bits;
}

// The workspace's parts, as byte offsets, and cub's temp storage size.
struct Layout {
  long long partial, scalars, keys[2], ids[2], spheres, temp, end;
  size_t temp_bytes;
};

long long align_up(long long x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }

cudaError_t layout(long long n, int gx, int zbits, Layout* l) {
  long long off = 0;
  auto take = [&off](long long bytes) {
    const long long at = off;
    off += align_up(bytes);
    return at;
  };
  l->partial = take(BOUNDS_BLOCKS * 8 * sizeof(float));
  l->scalars = take(sizeof(Scalars));
  for (int b = 0; b < 2; ++b) l->keys[b] = take(4 * n);
  for (int b = 0; b < 2; ++b) l->ids[b] = take(4 * n);
  l->spheres = take(sizeof(Sphere) * n);
  l->temp_bytes = 0;
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr), ids(nullptr, nullptr);
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, l->temp_bytes, keys, ids, static_cast<int>(n), 0,
      key_bits(gx, zbits));
  if (err != cudaSuccess) return err;
  l->temp = take(static_cast<long long>(l->temp_bytes));
  l->end = off;
  return cudaSuccess;
}

// n in [1, 2^31), gx in [1, 4096], and every key col << zbits | zq, col <
// gx, in 32 bits.
bool valid(long long n, int gx, int zbits) {
  return n >= 1 && n < (1LL << 31) && gx >= 1 && gx <= 4096 && zbits >= 1 &&
         zbits <= 31 &&
         (static_cast<unsigned long long>(gx) << zbits) <= (1ULL << 32);
}

}  // namespace

// The workspace bytes slab_plan_launch takes for n spheres at gx slabs
// and zbits bits of z, into *bytes.
extern "C" int slab_plan_workspace(long long n, int gx, int zbits,
                                   long long* bytes) {
  if (!bytes || !valid(n, gx, zbits))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = layout(n, gx, zbits, &l);
  *bytes = l.end;
  return static_cast<int>(err);
}

// The slab plan of n spheres (coords float[n, 3], radii float[n]) at gx
// slabs, zbits bits of z and mc chunks a slab: the stream float[rows, 8,
// 128], starts int[gx + 2], w0 and wcap int[gx, mc * 2], maxima int[3]
// (rows_rolled, max_col, max_slab_rows), ok (one byte: no slab holds more
// than col_capacity spheres, none spans more than slab_rows - 2 stream
// rows) and diag_thr float[1]; work: work_bytes of device memory, at least
// slab_plan_workspace's.
extern "C" int slab_plan_launch(const void* coords, const void* radii,
                                long long n, int gx, int zbits, int mc,
                                int col_capacity, int slab_rows,
                                long long rows, void* work,
                                long long work_bytes, void* stream_out,
                                void* starts, void* w0, void* wcap,
                                void* maxima, void* ok, void* diag_thr,
                                void* stream) {
  if (!valid(n, gx, zbits) || mc < 1 || rows * LANE < n || !coords ||
      !radii || !work || !stream_out || !starts || !w0 || !wcap || !maxima ||
      !ok || !diag_thr || (reinterpret_cast<uintptr_t>(w0) & 7) ||
      (reinterpret_cast<uintptr_t>(wcap) & 7) ||
      (reinterpret_cast<uintptr_t>(work) & (ALIGN - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  cudaError_t err = layout(n, gx, zbits, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_bytes < l.end) return static_cast<int>(cudaErrorInvalidValue);
  char* w = static_cast<char*>(work);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* partial = reinterpret_cast<float*>(w + l.partial);
  Scalars* scalars = reinterpret_cast<Scalars*>(w + l.scalars);
  unsigned* keys[2] = {reinterpret_cast<unsigned*>(w + l.keys[0]),
                       reinterpret_cast<unsigned*>(w + l.keys[1])};
  unsigned* ids[2] = {reinterpret_cast<unsigned*>(w + l.ids[0]),
                      reinterpret_cast<unsigned*>(w + l.ids[1])};
  Sphere* spheres = reinterpret_cast<Sphere*>(w + l.spheres);
  int* most = static_cast<int*>(maxima);
  unsigned char* okp = static_cast<unsigned char*>(ok);

  const long long want = (3 * n + THREADS - 1) / THREADS;
  const int blocks =
      static_cast<int>(std::min<long long>(BOUNDS_BLOCKS, (want + 2) / 3 * 3));
  bounds_kernel<<<blocks, THREADS, 0, cs>>>(
      static_cast<const float*>(coords), static_cast<const float*>(radii), n,
      partial);
  scalars_kernel<<<1, THREADS, 0, cs>>>(partial, blocks, gx, zbits, scalars,
                                        static_cast<float*>(diag_thr), most,
                                        okp);
  keys_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS,
                0, cs>>>(static_cast<const float*>(coords),
                         static_cast<const float*>(radii), n, gx, zbits,
                         scalars, keys[0], ids[0], spheres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned> dk(keys[0], keys[1]), dv(ids[0], ids[1]);
  size_t temp_bytes = l.temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(w + l.temp, temp_bytes, dk, dv,
                                        static_cast<int>(n), 0,
                                        key_bits(gx, zbits), cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* st = static_cast<int*>(starts);
  starts_kernel<<<(gx + 2 + THREADS - 1) / THREADS, THREADS, 0, cs>>>(
      dk.Current(), n, gx, zbits, st);
  const long long lanes = rows * LANE;
  float* out = static_cast<float*>(stream_out);
  stream_kernel<<<static_cast<unsigned>((lanes + THREADS - 1) / THREADS),
                  THREADS, 0, cs>>>(spheres, dk.Current(), dv.Current(), n,
                                    lanes, zbits, out);
  const long long chunks = static_cast<long long>(gx) * mc;
  const int tblocks = static_cast<int>(std::min<long long>(
      TABLE_BLOCKS, (chunks + WARPS * GROUP - 1) / (WARPS * GROUP)));
  tables_kernel<<<tblocks, THREADS, 0, cs>>>(
      out, dk.Current(), st, scalars, gx, mc, zbits, col_capacity, slab_rows,
      static_cast<int2*>(w0), static_cast<int2*>(wcap), most, okp);
  return static_cast<int>(cudaGetLastError());
}
