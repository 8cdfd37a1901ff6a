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
// Every subtraction, addition, product and division is rounded as
// bucket_sort.cuh states, in the plain path's order.
//
// What bounds it on the H100. At 16M spheres and gx 1000: the centres and
// radii, 256 MB, read once; the keys, ids and packed records, 384 MB,
// written once and read once; the stream, 538 MB, written once: 0.47 ms
// at 3.35 TB/s. The sort moves 16M 32-bit keys with 32-bit ids, four
// 8-bit digit passes of 128 MB read and 128 MB written each: 0.31 ms
// more. The tables read the stream's two z channels and search the keys.
//
// What the design does about it. Six kernels and cub's sort in stream
// order, nothing read back by the host (* marks bucket_sort.cuh's steps):
// bounds_partial_kernel*, scalars_kernel, keys_kernel, sort_pairs* on
// bits [0, zbits + bit_length(gx - 1)) only, the bits a key can hold (4
// digit passes at gx 1000 where an int64 key takes 8),
// bucket_starts_kernel*, stream_kernel, which writes the stream once,
// never filled first, and tables_kernel, which reads the chunks' z ranges
// from the stream and runs their threshold searches at once, a binary
// search a lane.

#include "bucket_sort.cuh"
#include "stream.cuh"

namespace {

using stream::CHUNK;
using stream::LANE;

// The tables kernel's blocks at most: as many as the bounds kernel's.
constexpr int TABLE_BLOCKS = BOUNDS_BLOCKS;
constexpr int CHANNELS = 8;
// Chunks a warp of the tables kernel takes at a time: one search a lane.
constexpr int GROUP = 8;

// The plan's scalars, made on the card by scalars_kernel.
struct Scalars {
  float lo_x, lo_z, sx, zscale, zhi_scene, r_max;
};

// One block: the plan's scalars and diag_thr from the partials;
// maxima[0..2] = 0, *ok = 1. gx, zbits and the capacities arrive as
// arguments: no constant from the host.
__global__ void __launch_bounds__(THREADS)
    scalars_kernel(const float* __restrict__ partial, int blocks, int gx,
                   int zbits, Scalars* __restrict__ s,
                   float* __restrict__ diag_thr, int* __restrict__ maxima,
                   unsigned char* ok) {
  float v[NB];
  fold_partials(partial, blocks, v);
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
                Sphere<float>* __restrict__ spheres) {
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
  spheres[i] = Sphere<float>{x, y, z, radii[i]};
}

// Lane p of the stream, p in [0, rows * 128): sorted sphere p's eight
// channels, or +inf past n; a warp's stores to a channel are 128
// contiguous bytes.
__global__ void __launch_bounds__(THREADS)
    stream_kernel(const Sphere<float>* __restrict__ spheres,
                  const unsigned* __restrict__ keys,
                  const unsigned* __restrict__ ids, long long n,
                  long long lanes, int zbits, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (p >= lanes) return;
  float v[CHANNELS];
  if (p < n) {
    const unsigned id = ids[p];
    const Sphere<float> b = spheres[id];
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
    for (int c = 0; c < CHANNELS; ++c) v[c] = pos_inf<float>();
  }
  float* at = out + (p / LANE) * (CHANNELS * LANE) + p % LANE;
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) at[c * LANE] = v[c];
}

// A warp takes GROUP chunks t = c * mc + k at a time: their z ranges one
// after the other, from the stream's zlo and zhi channels, two lanes a
// thread; then their 4 * GROUP threshold searches at once, lane 4j + e
// the search e of chunk j inside its slab's sorted range; lane 4j writes
// chunk j's windows into w0 / wcap [gx, mc, 2] as one 8-byte store each.
// The self slab's first search is one load where the window starts at the
// chunk start, as it does wherever no radius is negative. Chunk 0 of each
// slab also gives its size and rows; a block folds its maxima
// (rows_rolled, max_col, max_slab_rows) into one atomicMax each.
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
    float lo = pos_inf<float>(), hi = -pos_inf<float>();
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
      float zlo = pos_inf<float>(), zhi = -pos_inf<float>();
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
                                : lower_bound<long long>(
                                      keys, g0 + 1, starts[c + 1], target);
      else
        at = lower_bound<long long>(keys, starts[b], starts[b + 1],
                                    target);
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
int key_bits(int gx, int zbits) { return zbits + bit_length(gx - 1); }

using Layout = PlanLayout<Scalars>;

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
  const cudaError_t err = l.carve(n, key_bits(gx, zbits));
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
  cudaError_t err = l.carve(n, key_bits(gx, zbits));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_bytes < l.end) return static_cast<int>(cudaErrorInvalidValue);
  char* w = static_cast<char*>(work);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* partial = carved<float>(w, l.partial);
  Scalars* scalars = carved<Scalars>(w, l.scalars);
  Sphere<float>* spheres = carved<Sphere<float>>(w, l.spheres);
  int* most = static_cast<int*>(maxima);
  unsigned char* okp = static_cast<unsigned char*>(ok);
  const float* c = static_cast<const float*>(coords);
  const float* r = static_cast<const float*>(radii);
  const int blocks = bounds_partials(c, r, n, partial, cs);
  scalars_kernel<<<1, THREADS, 0, cs>>>(partial, blocks, gx, zbits, scalars,
                                        static_cast<float*>(diag_thr), most,
                                        okp);
  keys_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS,
                0, cs>>>(c, r, n, gx, zbits, scalars,
                         carved<unsigned>(w, l.keys[0]),
                         carved<unsigned>(w, l.ids[0]), spheres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned> dk, dv;
  err = l.sort_pairs(w, n, key_bits(gx, zbits), cs, &dk, &dv);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* st = static_cast<int*>(starts);
  // starts[b] = the first sorted index of slab b, b in [0, gx + 2).
  bucket_starts(dk.Current(), n, gx + 2, zbits, st, cs);
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
