// The column engine's plan, built on the card in one chain: the scene's
// bounds and the plan's scalars, a 32-bit key a sphere, a stable sort on
// the key's bits, the column starts, one pass that writes the sorted
// stream, and one pass that writes the window tables and the retry's
// statistics.
//
// Replaces no TPU kernel: the JAX package builds the plan with XLA ops
// (collision_tpu/columns.py: plan_columns). The port's torch ops for the
// same (columns.plan_columns_plain, the CPU path and the reference of the
// card tests) issued ~290 aten ops, a sort of int64 keys, gathers, an [8,
// n] stack and its transposed copy, a [gxy^2, mc, 64] gather for the
// chunks' z ranges, a batched searchsorted of 10 gxy^2 mc thresholds, and
// five host syncs a plan.
//
// The plan, bit for bit the plain path's: spheres sort stably by key
// col << zbits | quantize(z), col = cx gxy + cy, cx = clamp(trunc((x -
// lo_x) / sx), 0, gxy - 1) and cy likewise on y, s = max(2 r_max, (hi -
// lo) / gxy) on each of x and y, 1 where not positive; quantize(z) =
// min(trunc(clamp((z - lo_z) * zscale, 0, 2^32)), zmax), zscale = zmax /
// zext, zext the z extent, 1 where not positive. The stream is [rows, 8,
// 128] float: sorted sphere p is lane p % 128 of row p / 128, channels c
// - r on three axes, c + r, the id's bits and +inf; +inf past n. starts[b]
// is the first sorted index of extended column b, b in [0, (gxy + 1) gxy
// + 1): the pad x-row gxy stays empty. Chunk k of column c holds sorted
// spheres [starts[c] + 64k, min(starts[c] + 64k + 64, starts[c + 1])); its
// z range is the min of their zlo and the max of their zhi, its
// thresholds that range widened by r_max, clamped to [lo_z, max(lo_z +
// zmax / zscale, hi_z)] and quantized; its window in column (cx + dx, cy
// + dy), for the five (dx, dy) of columns.COLUMN_OFFSETS, is the sorted
// range of keys [b << zbits | qlo, (b << zbits) + qhi + 1), b that
// column's id, the self column's clipped at the chunk start; an empty
// chunk's windows, and those whose cy + dy leaves the grid, are (0, 0).
// Every subtraction, addition, product and division is rounded as
// bucket_sort.cuh states, in the plain path's order.
//
// What bounds it on the H100. At the reference's dense scene (307,200
// spheres, gxy 14, 72 chunks a column, 295 slab rows): the centres and
// radii, 4.9 MB, read once; the keys, ids and packed records, 7.4 MB,
// written once and read once; the stream, 11.0 MB, written once; the
// tables, 0.56 MB: ~7 us at 3.35 TB/s. The sort moves 307,200 32-bit
// keys with 32-bit ids, four 8-bit digit passes: ~6 us more. At this size
// the chain is bound by its launches, not its bytes.
//
// What the design does about it. Six kernels and cub's sort in stream
// order, nothing read back by the host (* marks bucket_sort.cuh's steps):
// bounds_partial_kernel*, column_scalars_kernel, column_keys_kernel,
// sort_pairs* on bits [0, zbits + bit_length(gxy^2 - 1)) only, the bits a
// key can hold, bucket_starts_kernel*, column_stream_kernel, which writes
// the stream once, never filled first, and column_tables_kernel, which
// reads the chunks' z ranges from the stream's zlo and zhi channels and
// runs their ten threshold searches at once, a binary search a lane.

#include "bucket_sort.cuh"
#include "stream.cuh"

namespace {

using stream::CHUNK;
using stream::LANE;

// The tables kernel's blocks at most: as many as the bounds kernel's.
constexpr int TABLE_BLOCKS = BOUNDS_BLOCKS;
constexpr int CHANNELS = 8;
// The half-stencil's offsets (columns.COLUMN_OFFSETS), two searches each.
constexpr int NOFF = 5;
constexpr int SEARCHES = 2 * NOFF;
// Chunks a warp of the tables kernel takes at a time: one search a lane.
constexpr int GROUP = 32 / SEARCHES;
// The retry's statistics, in the order the wrapper reads them.
constexpr int STATS = 4;  // rows_needed, rows_rolled, max_col, max_slab_rows

// The plan's scalars, made on the card by column_scalars_kernel.
struct Scalars {
  float lo_x, lo_y, lo_z, sx, sy, zscale, zhi_scene, r_max;
};

// One block: the plan's scalars from the partials; stats = 0, *ok = 1.
// gxy and zbits arrive as arguments: no constant from the host.
__global__ void __launch_bounds__(THREADS)
    column_scalars_kernel(const float* __restrict__ partial, int blocks,
                          int gxy, int zbits, Scalars* __restrict__ s,
                          int* __restrict__ stats, unsigned char* ok) {
  float v[NB];
  fold_partials(partial, blocks, v);
  if (threadIdx.x != 0) return;
  const float r_max = v[6];
  const float two_r = __fmul_rn(2.0f, r_max);
  float size[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float w = greater(two_r, __fdiv_rn(__fsub_rn(v[3 + a], v[a]),
                                             static_cast<float>(gxy)));
    size[a] = w > 0.0f ? w : 1.0f;
  }
  const float ext_z = __fsub_rn(v[5], v[2]);
  const float zext = ext_z > 0.0f ? ext_z : 1.0f;
  const float zmax = __uint2float_rn((1u << zbits) - 1);
  const float zscale = __fdiv_rn(zmax, zext);
  // The plain path's top: lo_z + zmax / zscale, or the topmost centre where
  // that rounds below it.
  const float top = greater(__fadd_rn(v[2], __fdiv_rn(zmax, zscale)), v[5]);
  *s = Scalars{v[0], v[1], v[2], size[0], size[1], zscale, top, r_max};
#pragma unroll
  for (int m = 0; m < STATS; ++m) stats[m] = 0;
  *ok = 1;
}

// The cell of coordinate c on one axis: clamp(trunc((c - lo) / s), 0,
// gxy - 1).
__device__ inline int cell(float c, float lo, float s, int gxy) {
  return min(max(__float2int_rz(__fdiv_rn(__fsub_rn(c, lo), s)), 0),
             gxy - 1);
}

// Each sphere's key, its id, and its centre and radius packed for the
// stream pass's gather.
__global__ void __launch_bounds__(THREADS)
    column_keys_kernel(const float* __restrict__ coords,
                       const float* __restrict__ radii, long long n, int gxy,
                       int zbits, const Scalars* __restrict__ s,
                       unsigned* __restrict__ keys, unsigned* __restrict__ ids,
                       Sphere<float>* __restrict__ spheres) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= n) return;
  const Scalars p = *s;
  const float x = coords[3 * i], y = coords[3 * i + 1], z = coords[3 * i + 2];
  const unsigned col = static_cast<unsigned>(
      cell(x, p.lo_x, p.sx, gxy) * gxy + cell(y, p.lo_y, p.sy, gxy));
  keys[i] = (col << zbits) | quantize(z, p.lo_z, p.zscale, (1u << zbits) - 1);
  ids[i] = static_cast<unsigned>(i);
  spheres[i] = Sphere<float>{x, y, z, radii[i]};
}

// Lane p of the stream, p in [0, rows * 128): sorted sphere p's seven
// channels and +inf, or +inf past n; a warp's stores to a channel are 128
// contiguous bytes.
__global__ void __launch_bounds__(THREADS)
    column_stream_kernel(const Sphere<float>* __restrict__ spheres,
                         const unsigned* __restrict__ ids, long long n,
                         long long lanes, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (p >= lanes) return;
  float v[CHANNELS];
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) v[c] = pos_inf<float>();
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
  }
  float* at = out + (p / LANE) * (CHANNELS * LANE) + p % LANE;
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) at[c * LANE] = v[c];
}

// A warp takes GROUP chunks t = c * mc + k at a time: their z ranges one
// after the other, from the stream's zlo and zhi channels, two lanes a
// thread; then their SEARCHES * GROUP threshold searches at once, lane
// SEARCHES j + e the search e of chunk j, e = 2 off + f: offset off's
// threshold, f 0 its first key (qlo), f 1 its end (qhi + 1), inside the
// target column's sorted range. Lane SEARCHES j + 2 off writes chunk j's
// window at offset off into w0 / wcap [gxy^2, mc, 5]. The self column's
// first search is one load where the window starts at the chunk start, as
// it does wherever no radius is negative. Chunk 0 of each column gives its
// size, and of each x-row's first column the stream rows the x-row spans;
// a block folds its maxima into one atomicMax each.
__global__ void __launch_bounds__(THREADS)
    column_tables_kernel(const float* __restrict__ stream,
                         const unsigned* __restrict__ keys,
                         const int* __restrict__ starts,
                         const Scalars* __restrict__ s, int gxy, int mc,
                         int zbits, int col_capacity, int slab_rows,
                         int* __restrict__ w0, int* __restrict__ wcap,
                         int* __restrict__ stats, unsigned char* ok) {
  __shared__ int part[WARPS][STATS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = lane / SEARCHES, e = lane % SEARCHES, off = e >> 1;
  // COLUMN_OFFSETS: (0, 0), (0, 1), (1, -1), (1, 0), (1, 1).
  const int dx = off < 2 ? 0 : 1;
  const int dy = off == 0 ? 0 : off == 1 ? 1 : off - 3;
  const Scalars p = *s;
  const unsigned zmax = (1u << zbits) - 1;
  const long long chunks = static_cast<long long>(gxy) * gxy * mc;
  int most[STATS] = {0, 0, 0, 0};
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
        most[2] = max(most[2], size);
        bool short_of = size > col_capacity;
        if (c % gxy == 0) {
          // x-row c / gxy: columns [c, c + gxy), stream rows from the row of
          // its first sphere to that of its last.
          const long long r1 = starts[c + gxy];
          const int rows = static_cast<int>((r1 + LANE - 1) / LANE - s0 / LANE);
          most[3] = max(most[3], rows);
          short_of = short_of || rows + 2 > slab_rows;
        }
        if (lane == 0 && short_of) *ok = 0;
      }
      const long long g0 = s0 + static_cast<long long>(CHUNK) * k;
      float zlo = pos_inf<float>(), zhi = -pos_inf<float>();
#pragma unroll
      for (int h = 0; h < CHUNK; h += 32)
        if (g0 + h + lane < s1) {
          zlo = lesser(zlo, stream::comp(stream, g0 + h + lane, 2));
          zhi = greater(zhi, stream::comp(stream, g0 + h + lane, 5));
        }
      for (int o = 16; o > 0; o >>= 1) {
        zlo = lesser(zlo, __shfl_xor_sync(0xffffffffu, zlo, o));
        zhi = greater(zhi, __shfl_xor_sync(0xffffffffu, zhi, o));
      }
      if (j == mine) {
        lo = zlo;
        hi = zhi;
      }
    }
    const long long t = t0 + mine;
    const bool mine_live = mine < GROUP && t < chunks;
    const long long tc = min(t, chunks - 1);
    const int c = static_cast<int>(tc / mc);
    const int k = static_cast<int>(tc % mc);
    const int yb = c % gxy + dy;
    const long long g0 = starts[c] + static_cast<long long>(CHUNK) * k;
    const bool live =
        mine_live && g0 < starts[c + 1] && yb >= 0 && yb < gxy;
    long long at = 0;
    if (live) {
      const unsigned qlo = quantize(
          lesser(greater(__fsub_rn(lo, p.r_max), p.lo_z), p.zhi_scene),
          p.lo_z, p.zscale, zmax);
      const unsigned qhi = quantize(
          lesser(greater(__fadd_rn(hi, p.r_max), p.lo_z), p.zhi_scene),
          p.lo_z, p.zscale, zmax);
      const int b = (c / gxy + dx) * gxy + yb;
      const unsigned long long target =
          (static_cast<unsigned long long>(b) << zbits) +
          ((e & 1) ? static_cast<unsigned long long>(qhi) + 1 : qlo);
      if (e == 0)
        // The self column's window, clipped at the chunk start (j > i),
        // starts past it only where the chunk's first key is below the
        // threshold.
        at = keys[g0] >= target ? g0
                                : lower_bound<long long>(
                                      keys, g0 + 1, starts[c + 1], target);
      else
        at = lower_bound<long long>(keys, starts[b], starts[b + 1], target);
    }
    const long long end = __shfl_down_sync(0xffffffffu, at, 1);
    if (mine_live && !(e & 1)) {
      const long long cap = live ? max(end - at, 0LL) : 0;
      w0[t * NOFF + off] = static_cast<int>(at);
      wcap[t * NOFF + off] = static_cast<int>(cap);
      // Stream rows the window spans from its aligned row, and 128-lane
      // rows from its own start.
      most[0] = max(most[0], static_cast<int>((at % LANE + cap + LANE - 1) /
                                              LANE));
      most[1] = max(most[1], static_cast<int>((cap + LANE - 1) / LANE));
    }
  }
#pragma unroll
  for (int m = 0; m < STATS; ++m)
    most[m] = __reduce_max_sync(0xffffffffu, most[m]);
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < STATS; ++m) part[warp][m] = most[m];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < WARPS; ++w)
#pragma unroll
    for (int m = 0; m < STATS; ++m) most[m] = max(most[m], part[w][m]);
#pragma unroll
  for (int m = 0; m < STATS; ++m)
    if (most[m] > 0) atomicMax(stats + m, most[m]);
}

// The bits a key can hold: zbits of z and bit_length(gxy^2 - 1) of column.
int key_bits(int gxy, int zbits) {
  return zbits + bit_length(static_cast<unsigned long long>(gxy) * gxy - 1);
}

using Layout = PlanLayout<Scalars>;

// n in [1, 2^31), gxy >= 1, and every threshold (b << zbits) + qhi + 1 of
// an extended column b < (gxy + 1) gxy in 32 bits.
bool valid(long long n, int gxy, int zbits) {
  if (n < 1 || n >= (1LL << 31) || gxy < 1 || zbits < 1 || zbits > 31)
    return false;
  const unsigned long long ext = (gxy + 1ULL) * gxy;
  return ext < (1ULL << 31) && ((ext + 1) << zbits) <= (1ULL << 32);
}

}  // namespace

// The workspace bytes column_plan_launch takes for n spheres at gxy
// columns a side and zbits bits of z, into *bytes.
extern "C" int column_plan_workspace(long long n, int gxy, int zbits,
                                     long long* bytes) {
  if (!bytes || !valid(n, gxy, zbits))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = l.carve(n, key_bits(gxy, zbits));
  *bytes = l.end;
  return static_cast<int>(err);
}

// The column plan of n spheres (coords float[n, 3], radii float[n]) at
// gxy columns a side, zbits bits of z and mc chunks a column: the stream
// float[rows, 8, 128], starts int[(gxy + 1) gxy + 1], w0 and wcap int[gxy,
// gxy * mc * 5], stats int[4] (rows_needed, rows_rolled, max_col,
// max_slab_rows) and ok (one byte: no column holds more than col_capacity
// spheres, no x-row spans more than slab_rows - 2 stream rows); work:
// work_bytes of device memory, at least column_plan_workspace's.
extern "C" int column_plan_launch(const void* coords, const void* radii,
                                  long long n, int gxy, int zbits, int mc,
                                  int col_capacity, int slab_rows,
                                  long long rows, void* work,
                                  long long work_bytes, void* stream_out,
                                  void* starts, void* w0, void* wcap,
                                  void* stats, void* ok, void* stream) {
  if (!valid(n, gxy, zbits) || mc < 1 || rows * LANE < n || !coords ||
      !radii || !work || !stream_out || !starts || !w0 || !wcap || !stats ||
      !ok || (reinterpret_cast<uintptr_t>(work) & (ALIGN - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  cudaError_t err = l.carve(n, key_bits(gxy, zbits));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_bytes < l.end) return static_cast<int>(cudaErrorInvalidValue);
  char* w = static_cast<char*>(work);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* partial = carved<float>(w, l.partial);
  Scalars* scalars = carved<Scalars>(w, l.scalars);
  Sphere<float>* spheres = carved<Sphere<float>>(w, l.spheres);
  int* st = static_cast<int*>(stats);
  unsigned char* okp = static_cast<unsigned char*>(ok);
  const float* c = static_cast<const float*>(coords);
  const float* r = static_cast<const float*>(radii);
  const int blocks = bounds_partials(c, r, n, partial, cs);
  column_scalars_kernel<<<1, THREADS, 0, cs>>>(partial, blocks, gxy, zbits,
                                               scalars, st, okp);
  column_keys_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                       THREADS, 0, cs>>>(c, r, n, gxy, zbits, scalars,
                                         carved<unsigned>(w, l.keys[0]),
                                         carved<unsigned>(w, l.ids[0]),
                                         spheres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned> dk, dv;
  err = l.sort_pairs(w, n, key_bits(gxy, zbits), cs, &dk, &dv);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* bucket = static_cast<int*>(starts);
  // starts[b] = the first sorted index of extended column b.
  bucket_starts(dk.Current(), n, (gxy + 1LL) * gxy + 1, zbits, bucket, cs);
  const long long lanes = rows * LANE;
  float* out = static_cast<float*>(stream_out);
  column_stream_kernel<<<static_cast<unsigned>((lanes + THREADS - 1) /
                                               THREADS),
                         THREADS, 0, cs>>>(spheres, dv.Current(), n, lanes,
                                           out);
  const long long chunks = static_cast<long long>(gxy) * gxy * mc;
  const int tblocks = static_cast<int>(std::min<long long>(
      TABLE_BLOCKS, (chunks + WARPS * GROUP - 1) / (WARPS * GROUP)));
  column_tables_kernel<<<tblocks, THREADS, 0, cs>>>(
      out, dk.Current(), bucket, scalars, gxy, mc, zbits, col_capacity,
      slab_rows, static_cast<int*>(w0), static_cast<int*>(wcap), st, okp);
  return static_cast<int>(cudaGetLastError());
}
