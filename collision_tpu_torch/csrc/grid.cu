// Dense uniform-grid kernels: the grid count (a total or per tile) and the
// tile emission.
//
// Replaces collision_tpu/kernels/halo.py: _make_kernel (reached through
// halo_pairs: its count, and its fused emission as the tile counts, a scan
// and the emission), collision_tpu/kernels/batched.py: _make_kernel
// (batched_count, which takes the same count kernel here), and
// collision_tpu/kernels/emit.py: _make_counts_kernel (halo_tile_counts)
// and _make_emit_kernel (emit_pairs).
//
// The bins are f32[gp, gp, gp, M, 8], gp = gd + 2: cell (x, y, z) of the
// grid is padded cell (x+1, y+1, z+1), and the border cells are +inf. A row
// is xlo ylo zlo id-bits xhi yhi zhi pad; empty slots are +inf rows. A tile
// is a center cell against itself (o = 0, pairs j > i) or against one of
// the 13 half-stencil neighbours (o = 1..13, in grid.py's _HALF_OFFSETS
// order). The test is the strict a.hi > b.lo && a.lo < b.hi on each axis,
// with no epsilon and no arithmetic on the bounds. A row whose xlo is not
// below +inf (+inf or NaN) fails it whatever it meets, so each cell's rows
// are cut after its last live row and the tests run are the live ones.
//
// What bounds it on the H100. The count: at 1M uniform spheres, gd 24
// and M 120 (72 spheres a cell on average), the tiles hold ~0.9G live
// pairs, but a face neighbour can only meet the ~5% of a cell's rows
// within 2 r_max of the shared face (edge and corner neighbours fewer),
// so the tests the inputs need are the self tiles' ~35M and a few M
// more: 0.003 ms at the float32 peak, against 67.5 MB of bins read once,
// 0.02 ms. So the count is bound by bytes; it reads each cell from L2
// up to 14 times.
//
// What the design does about it. The count: one warp per center cell,
// which stages the cell (in 128-row chunks) in shared memory with its
// union box, tests the self tile's triangle j > i, then each neighbour
// tile: it loads the neighbour's rows into registers, forms their union
// box, and tests only the center rows that meet the neighbour's union
// against the neighbour rows that meet the center's (cull.cuh: exact,
// so counts and totals stay bit-identical). The per-tile counts sum in
// shared memory, the total takes one integer atomic a block:
// deterministic. At 1M it takes ~0.14 ms on an H100, 7x its bytes
// bound, and L2 bandwidth is not what holds it: a first pass that
// tables each cell's union and occupancy, so that a neighbour's rows are
// read only where a center row meets its union (~4x fewer bytes), took
// 10-11% longer in all; prefetching the next tile's rows into registers
// took 19-28% longer. (A count that tested every live pair, one warp a
// center row against 32 b rows an instruction, took 0.80-0.86 ms; a
// block of two y-adjacent centers sharing their neighbourhood was
// 15-22% slower than that.)
//
// The emission: one 128-thread block per hit tile, the b cell's rows in
// registers (lane l holding rows l, l+32, l+64 and l+96 of a 128-row
// chunk), each warp walking the a rows, which all its lanes read at one
// address (a broadcast load). It ranks hits without the TPU's cursor:
// pass 1 counts each a row's hits (warp ballots and __popc), a block scan
// turns the counts into row offsets, pass 2 tests again and writes hit
// (i, j) at base + row offset + the row's hits before j, below capacity
// only, with int64 slots: row-major, the order of the TPU kernel's
// sequential extraction. It tests every live pair of its tiles (not yet
// culled). Ids are read as bits, never converted (small ids are
// denormals). Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "cull.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BREG = 4;              // b rows a lane holds per chunk
constexpr int BCHUNK = 32 * BREG;    // b rows per chunk; a rows per emission chunk
constexpr unsigned FULL = 0xffffffffu;

static_assert(BCHUNK == THREADS, "the emission scans one a row per thread");

struct Row {
  float lo[3], hi[3];
  int id;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool live(float xlo) { return xlo < pos_inf(); }

// The rows of padded cell (x, y, z), two float4 per row.
__device__ __forceinline__ const float4* cell_rows(const float4* bins, int gp,
                                                   int M, int x, int y, int z) {
  return bins + ((static_cast<long long>(x) * gp + y) * gp + z) * M * 2;
}

__device__ __forceinline__ Row row_of(float4 lo, float4 hi) {
  Row r;
  r.lo[0] = lo.x; r.lo[1] = lo.y; r.lo[2] = lo.z;
  r.id = __float_as_int(lo.w);
  r.hi[0] = hi.x; r.hi[1] = hi.y; r.hi[2] = hi.z;
  return r;
}

// Row i of a cell, or of a chunk staged in shared memory.
__device__ __forceinline__ Row load_row(const float4* __restrict__ cell, int i) {
  return row_of(cell[2 * i], cell[2 * i + 1]);
}

__device__ __forceinline__ Row dead_row() {
  Row r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.lo[c] = pos_inf();
    r.hi[c] = -pos_inf();
  }
  r.id = -1;
  return r;
}

// Strict AABB overlap (collision.cl:164-166).
__device__ __forceinline__ bool overlaps(const Row& a, const Row& b) {
  return (a.hi[0] > b.lo[0]) & (a.lo[0] < b.hi[0]) &
         (a.hi[1] > b.lo[1]) & (a.lo[1] < b.hi[1]) &
         (a.hi[2] > b.lo[2]) & (a.lo[2] < b.hi[2]);
}

// 1 + the index of the cell's last live row (0 when it has none), by a
// block-wide atomicMax into *occ, which the caller zeroed.
__device__ __forceinline__ void cell_occupancy(const float4* __restrict__ cell,
                                               int M, int* occ) {
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    if (live(cell[2 * i].x)) atomicMax(occ, i + 1);
}

// The lane's rows b0 + 32g + lane (g < BREG) of a b cell, dead past M.
// Returns the number of 32-row groups up to the chunk's last live row,
// the same in every lane of the warp.
__device__ __forceinline__ int load_b(const float4* __restrict__ cell, int M,
                                      int b0, Row (&b)[BREG]) {
  const int lane = threadIdx.x & 31;
  int groups = 0;
#pragma unroll
  for (int g = 0; g < BREG; ++g) {
    const int j = b0 + 32 * g + lane;
    b[g] = j < M ? load_row(cell, j) : dead_row();
    if (__ballot_sync(FULL, live(b[g].lo[0]))) groups = g + 1;
  }
  return groups;
}

// The neighbour cell offset of tile o: o = 0 the cell itself, o = 1..13
// grid.py's _HALF_OFFSETS in order (emit.py's decode).
struct Offset {
  int dx, dy, dz;
};

__device__ __forceinline__ Offset tile_offset(int o) {
  if (o >= 5) return {1, (o - 5) / 3 - 1, (o - 5) % 3 - 1};
  if (o >= 2) return {0, 1, o - 3};
  return {0, 0, o};
}

// Block = one warp = center cell (x, y, z). Writes its 14 tile counts to
// tc[(x*gd + y)*tile_pad + z*14 + o] (tc may be null) and adds their sum
// to *total (may be null).
//
// The center cell goes in chunks p of 128 rows, staged in shared memory
// with their union box ua. Its self tile is the chunk's triangle j > i
// and the rectangles against the cell's later chunks q > p; the 13
// neighbour tiles are rectangles against each chunk q of the neighbour
// cell. For a rectangle the warp loads the b chunk into registers (lane
// l: rows l, l+32, l+64, l+96), forms its union ub, marks the b rows
// that meet ua and the a rows that meet ub (ballots), and tests only
// marked a rows against the b groups that hold a marked row. (Blocks of
// 2 and 4 warps sharing a cell's tiles took 7% and 8-10% longer at 1M
// on an H100; 8 and 16, 24% and 84% longer than 4.)
__global__ void __launch_bounds__(32)
grid_count_kernel(const float4* __restrict__ bins, int gd, int M,
                  int* __restrict__ tc, int tile_pad,
                  unsigned long long* __restrict__ total) {
  const int gp = gd + 2;
  const int z = blockIdx.x % gd, y = blockIdx.x / gd % gd,
            x = blockIdx.x / (gd * gd);
  const int lane = threadIdx.x;
  __shared__ float4 sa[2 * BCHUNK];      // the center chunk's rows
  __shared__ int cnt[14];                // the tile counts
  if (lane < 14) cnt[lane] = 0;
  const float4* ac = cell_rows(bins, gp, M, x + 1, y + 1, z + 1);
  const int nq = (M + BCHUNK - 1) / BCHUNK;

  for (int p = 0; p < nq; ++p) {
    // Stage chunk p, dead past M, with its union ua and occupancy na
    // (1 + its last live row).
    __syncwarp();   // the previous chunk's readers are done
    cull::Box ua = cull::empty();
    int na = 0;
#pragma unroll
    for (int g = 0; g < BREG; ++g) {
      const int r = 32 * g + lane, i = p * BCHUNK + r;
      float4 lo = make_float4(pos_inf(), pos_inf(), pos_inf(), 0.0f), hi = lo;
      if (i < M) {
        lo = ac[2 * i];
        hi = ac[2 * i + 1];
      }
      sa[2 * r] = lo;
      sa[2 * r + 1] = hi;
      cull::add(ua, row_of(lo, hi));
      const unsigned lv = __ballot_sync(FULL, live(lo.x));
      if (lv) na = 32 * g + 32 - __clz(lv);
    }
    ua = cull::warp_union(ua);
    __syncwarp();
    if (na == 0) continue;
    const int groups = (na + 31) / 32;

    // The self tile's triangle: lane l holds rows l + 32g.
    {
      Row b[BREG];
#pragma unroll
      for (int g = 0; g < BREG; ++g) b[g] = load_row(sa, 32 * g + lane);
      int hits = 0;
      for (int r = 0; r < na - 1; ++r) {
        const Row a = load_row(sa, r);
#pragma unroll
        for (int g = 0; g < BREG; ++g)
          if (g < groups && 32 * g + 31 > r)
            hits += overlaps(a, b[g]) & (32 * g + lane > r);
      }
      hits = __reduce_add_sync(FULL, hits);
      if (lane == 0) cnt[0] += hits;
    }

    // The rectangles: o = 0 against chunks q > p of the cell itself, then
    // o = 1..13 against every chunk of the neighbour.
    for (int o = 0; o < 14; ++o) {
      const Offset d = tile_offset(o);
      const float4* bc = cell_rows(bins, gp, M, x + 1 + d.dx, y + 1 + d.dy,
                                   z + 1 + d.dz);
      for (int q = o == 0 ? p + 1 : 0; q < nq; ++q) {
        Row b[BREG];
#pragma unroll
        for (int g = 0; g < BREG; ++g) {
          const int j = q * BCHUNK + 32 * g + lane;
          b[g] = j < M ? load_row(bc, j) : dead_row();
        }
        cull::Box ub = cull::empty();
        unsigned keep[BREG];
        unsigned any = 0;
#pragma unroll
        for (int g = 0; g < BREG; ++g) {
          cull::add(ub, b[g]);
          keep[g] = __ballot_sync(FULL, cull::meets(b[g], ua));
          any |= keep[g];
        }
        if (!any) continue;   // no b row meets the chunk: no pair
        ub = cull::warp_union(ub);
        int hits = 0;
        for (int k = 0; k < groups; ++k) {
          unsigned am = __ballot_sync(
              FULL, cull::meets(load_row(sa, 32 * k + lane), ub));
          while (am) {
            const Row a = load_row(sa, 32 * k + __ffs(am) - 1);
            am &= am - 1;
#pragma unroll
            for (int g = 0; g < BREG; ++g)
              if (keep[g]) hits += overlaps(a, b[g]);
          }
        }
        hits = __reduce_add_sync(FULL, hits);
        if (lane == 0) cnt[o] += hits;
      }
    }
  }
  __syncwarp();
  if (tc && lane < 14)
    tc[static_cast<long long>(x * gd + y) * tile_pad + z * 14 + lane] =
        cnt[lane];
  if (total && lane == 0) {
    long long sum = 0;
    for (int o = 0; o < 14; ++o) sum += cnt[o];
    if (sum) atomicAdd(total, static_cast<unsigned long long>(sum));
  }
}

// Block = entry e: tile tiles[e], first slot bases[e]; an entry whose base
// is at or past capacity writes nothing.
__global__ void __launch_bounds__(THREADS)
grid_emit_kernel(const float4* __restrict__ bins, int gd, int M, int tile_pad,
                 const long long* __restrict__ tiles,
                 const long long* __restrict__ bases, long long capacity,
                 int2* __restrict__ pairs) {
  const long long e = blockIdx.x;
  const long long base = bases[e];
  const long long t = tiles[e];
  const long long col = t / tile_pad;
  const int zo = static_cast<int>(t % tile_pad);
  if (base >= capacity || t < 0 || col >= static_cast<long long>(gd) * gd ||
      zo >= 14 * gd)
    return;
  const int z = zo / 14, o = zo % 14;
  const int x = static_cast<int>(col / gd), y = static_cast<int>(col % gd);
  const Offset d = tile_offset(o);
  const int gp = gd + 2;
  const float4* ac = cell_rows(bins, gp, M, x + 1, y + 1, z + 1);
  const float4* bc = cell_rows(bins, gp, M, x + 1 + d.dx, y + 1 + d.dy,
                               z + 1 + d.dz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;

  __shared__ int amax;
  __shared__ int row_off[BCHUNK];   // a row's hits, then its next slot
  if (threadIdx.x == 0) amax = 0;
  __syncthreads();
  cell_occupancy(ac, M, &amax);
  __syncthreads();
  const int na = amax;

  long long carry = base;   // the same in every thread
  for (int a0 = 0; a0 < na && carry < capacity; a0 += BCHUNK) {
    const int rows = min(BCHUNK, na - a0);
    row_off[threadIdx.x] = 0;
    __syncthreads();
    // Pass 1: the hits of each a row of the chunk.
    for (int b0 = 0; b0 < M; b0 += BCHUNK) {
      Row b[BREG];
      const int groups = load_b(bc, M, b0, b);
      if (groups == 0) continue;
      for (int r = warp; r < rows; r += WARPS) {
        const int i = a0 + r;
        const Row a = load_row(ac, i);
        int c = 0;
#pragma unroll
        for (int g = 0; g < BREG; ++g)
          if (g < groups)
            c += __popc(__ballot_sync(
                FULL, overlaps(a, b[g]) & (o != 0 || b0 + 32 * g + lane > i)));
        if (lane == 0) row_off[r] += c;
      }
    }
    __syncthreads();
    int chunk_hits;
    const int off = scan::block_exclusive_scan(row_off[threadIdx.x],
                                               &chunk_hits);
    row_off[threadIdx.x] = off;
    __syncthreads();
    // Pass 2: each hit at its slot, row-major.
    for (int b0 = 0; b0 < M; b0 += BCHUNK) {
      Row b[BREG];
      const int groups = load_b(bc, M, b0, b);
      if (groups == 0) continue;
      for (int r = warp; r < rows; r += WARPS) {
        long long slot = carry + row_off[r];
        if (slot >= capacity) continue;
        const int i = a0 + r;
        const Row a = load_row(ac, i);
#pragma unroll
        for (int g = 0; g < BREG; ++g) {
          if (g < groups) {
            const bool hit =
                overlaps(a, b[g]) & (o != 0 || b0 + 32 * g + lane > i);
            const unsigned m = __ballot_sync(FULL, hit);
            const long long s = slot + __popc(m & below);
            if (hit && s < capacity) pairs[s] = make_int2(a.id, b[g].id);
            slot += __popc(m);
          }
        }
        if (lane == 0) row_off[r] = static_cast<int>(slot - carry);
        __syncwarp();
      }
    }
    carry += chunk_hits;
    __syncthreads();   // row_off is reset for the next chunk
  }
}

}  // namespace

// The grid count of padded bins f32[gd+2]^3 x [M, 8]: per-tile counts
// into tc (int32[gd^2, tile_pad], pad tiles zeroed by the caller; may be
// null) and/or their sum added to *total (may be null).
extern "C" int grid_count_launch(const float* bins, int gd, int M, int* tc,
                                 int tile_pad, unsigned long long* total,
                                 void* stream) {
  if (gd < 1 || M < 1 || (reinterpret_cast<uintptr_t>(bins) & 15) ||
      (tc && tile_pad < 14 * gd))
    return static_cast<int>(cudaErrorInvalidValue);
  grid_count_kernel<<<static_cast<unsigned>(gd) * gd * gd, 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(bins), gd, M, tc, tile_pad, total);
  return static_cast<int>(cudaGetLastError());
}

// The pairs of h tiles (tiles int64[h] flat tile ids) at their first slots
// bases int64[h], as (id_a, id_b) int32 pairs into
// pairs[capacity]; slots at or past capacity are not written.
extern "C" int grid_emit_launch(const float* bins, int gd, int M, int tile_pad,
                                const long long* tiles, const long long* bases,
                                long long h, long long capacity, int* pairs,
                                void* stream) {
  if (gd < 1 || M < 1 || tile_pad < 14 * gd || h < 0 || h > 0x7fffffffLL ||
      !tiles || !bases || (reinterpret_cast<uintptr_t>(bins) & 15) ||
      (reinterpret_cast<uintptr_t>(pairs) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h > 0 && capacity > 0)
    grid_emit_kernel<<<static_cast<unsigned>(h), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(bins), gd, M, tile_pad, tiles, bases,
        capacity, reinterpret_cast<int2*>(pairs));
  return static_cast<int>(cudaGetLastError());
}
