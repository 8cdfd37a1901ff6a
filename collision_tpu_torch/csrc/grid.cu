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
// The emission: at 1M its inputs are the 4873 hit tiles' rows and the
// 5940 pairs, 0.0037 ms of bytes; the fill launches it on 16384 entries
// (capacity 16384) of which 4873 are hit tiles, most of them self tiles
// holding one or two pairs among ~2,570 live tests. What holds it is the
// chain of dependent loads, tests and votes within a tile, not bytes or
// tests. The design: a warp per entry, four a block, in one pass. The
// warp holds the b cell's rows in registers and stages the a cell in
// shared memory (128-row chunks; a self tile writes its registers), then
// walks the a rows in ascending order, testing each against every 32-row
// group of b without branches; only when some lane hit (one warp vote)
// does it rank the hits, writing each at the running slot plus
// the hits of the lanes below (ballot and __popc): row-major, the order
// of the TPU kernel's sequential extraction, with no count pass, block
// scan or barrier. The fill's entries stop once they reach the next
// entry's base (their own count of pairs), and entries past the
// device-side hit count are not read, so no host sync sizes the launch.
// Neighbour tiles are culled by union boxes as in the count (cull.cuh);
// self tiles are not. On an H100 at the 1M fill this takes 0.040 ms
// against the earlier block-a-tile kernel's 0.104; without the vote
// 0.058, without the stop 0.070, one wave of resident blocks striding
// over the entries 0.043, without the cull 0.040 (0.34 against 0.29 on
// the dense oracle scene's grid (8, 192)); two rows a vote 0.038, but
// 0.45 on that dense grid. A b cell of more
// than 128 live rows reloads its chunks for each a row; on the dense
// grid, cells of ~128 rows, the emission matches the block kernel
// (0.29 ms each). Slots are int64 and written below capacity only. Ids
// are read as bits, never converted (small ids are denormals). Built
// without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cull.cuh"

namespace {

constexpr int BREG = 4;              // b rows a lane holds per chunk
constexpr int BCHUNK = 32 * BREG;    // rows per staged chunk
constexpr int EMIT_WARPS = 4;        // emission entries a block, one a warp
constexpr long long EMIT_MAX_BLOCKS = 1 << 20;   // then a grid-stride loop
constexpr unsigned FULL = 0xffffffffu;

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

// The lane's rows q*BCHUNK + 32g + lane (g < BREG) of a cell, dead past M.
__device__ __forceinline__ void load_chunk(const float4* __restrict__ cell,
                                           int M, int q, Row (&b)[BREG]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < BREG; ++g) {
    const int j = q * BCHUNK + 32 * g + lane;
    b[g] = j < M ? load_row(cell, j) : dead_row();
  }
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

// Writes a row's hits (hit[g]: b row 32g + lane of the chunk in
// registers) at slot on, below capacity, in ascending b order; moves slot
// past them.
__device__ __forceinline__ void rank_and_write(const bool (&hit)[BREG], int id,
                                               const Row (&b)[BREG],
                                               unsigned below,
                                               long long capacity,
                                               int2* __restrict__ pairs,
                                               long long& slot) {
#pragma unroll
  for (int g = 0; g < BREG; ++g) {
    const unsigned m = __ballot_sync(FULL, hit[g]);
    const long long s = slot + __popc(m & below);
    if (hit[g] && s < capacity) pairs[s] = make_int2(id, b[g].id);
    slot += __popc(m);
  }
}

// Warp = entry e (a grid-stride loop over the entries): tile tiles[e],
// first slot bases[e]; an entry whose base is at or past capacity, or
// whose tile is not a tile (NO_INDEX), writes nothing. With n_hit (the
// fill's entries: the *n_hit hit tiles in ascending order, each base the
// exclusive scan of every tile's count) only the first *n_hit entries
// are read, and entry e stops once it reaches the next entry's base.
//
// The warp walks the tile row-major in one pass: the a rows in ascending
// order (staged in shared memory in 128-row chunks), and for each the b
// rows in ascending 32-row groups (in registers, lane l holding rows l,
// l+32, l+64 and l+96 of a 128-row chunk). A group's hits take slots
// slot + __popc(ballot & the lanes below) and slot moves on by
// __popc(ballot): no count pass, no scan, no barrier. A b cell of more
// than 128 live rows reloads its chunks for each a row. On a neighbour
// tile only the a rows that meet the b cell's union box are walked, and
// only the b groups that hold a row meeting the a chunk's union are kept
// (cull.cuh: exact).
__global__ void __launch_bounds__(32 * EMIT_WARPS)
grid_emit_kernel(const float4* __restrict__ bins, int gd, int M, int tile_pad,
                 const long long* __restrict__ tiles,
                 const long long* __restrict__ bases, long long h,
                 const long long* __restrict__ n_hit, long long capacity,
                 int2* __restrict__ pairs) {
  __shared__ float4 stage[EMIT_WARPS][2 * BCHUNK];   // each warp's a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* sa = stage[warp];
  const unsigned below = (1u << lane) - 1;
  const long long entries = n_hit ? min(h, *n_hit) : h;
  const long long stride = static_cast<long long>(gridDim.x) * EMIT_WARPS;
  const int gp = gd + 2;

  for (long long e = static_cast<long long>(blockIdx.x) * EMIT_WARPS + warp;
       e < entries; e += stride) {
    const long long base = bases[e];
    const long long t = tiles[e];
    const long long col = t / tile_pad;
    const int zo = static_cast<int>(t % tile_pad);
    if (base >= capacity || t < 0 || col >= static_cast<long long>(gd) * gd ||
        zo >= 14 * gd)
      continue;
    // One past the entry's last slot that is written.
    const long long end =
        n_hit && e + 1 < entries ? min(capacity, bases[e + 1]) : capacity;
    const int z = zo / 14, o = zo % 14;
    const int x = static_cast<int>(col / gd), y = static_cast<int>(col % gd);
    const Offset d = tile_offset(o);
    const float4* ac = cell_rows(bins, gp, M, x + 1, y + 1, z + 1);
    const float4* bc = cell_rows(bins, gp, M, x + 1 + d.dx, y + 1 + d.dy,
                                 z + 1 + d.dz);
    const bool self = o == 0;
    const bool by_union = !self;   // neighbour tiles: culled by unions

    // The b cell: its union ub and nb = 1 + its last live row, over every
    // chunk; the registers keep chunk bq, the last one loaded.
    Row b[BREG];
    int bq = 0, nb = 0;
    cull::Box ub = cull::empty();
    for (int q = 0; q * BCHUNK < M; ++q) {
      bq = q;
      load_chunk(bc, M, q, b);
#pragma unroll
      for (int g = 0; g < BREG; ++g) {
        cull::add(ub, b[g]);
        const unsigned lv = __ballot_sync(FULL, live(b[g].lo[0]));
        if (lv) nb = q * BCHUNK + 32 * g + 32 - __clz(lv);
      }
    }
    if (by_union) ub = cull::warp_union(ub);
    const int nbq = (nb + BCHUNK - 1) / BCHUNK;

    long long slot = base;
    unsigned keep = 0;       // groups of chunk kq that can meet a chunk kp
    int kp = -1, kq = -1;
    for (int p = 0; p * BCHUNK < M && slot < end; ++p) {
      // Stage a chunk p, dead past M, with its union ua and na = 1 + its
      // last live row; a self tile's chunk in the registers is written
      // from them.
      __syncwarp();   // the previous chunk's readers are done
      cull::Box ua = cull::empty();
      int na = 0;
#pragma unroll
      for (int g = 0; g < BREG; ++g) {
        const int r = 32 * g + lane, i = p * BCHUNK + r;
        float4 lo, hi;
        if (self && bq == p) {
          lo = make_float4(b[g].lo[0], b[g].lo[1], b[g].lo[2],
                           __int_as_float(b[g].id));
          hi = make_float4(b[g].hi[0], b[g].hi[1], b[g].hi[2], 0.0f);
        } else if (i < M) {
          lo = ac[2 * i];
          hi = ac[2 * i + 1];
        } else {
          lo = hi = make_float4(pos_inf(), pos_inf(), pos_inf(), 0.0f);
        }
        sa[2 * r] = lo;
        sa[2 * r + 1] = hi;
        cull::add(ua, row_of(lo, hi));
        const unsigned lv = __ballot_sync(FULL, live(lo.x));
        if (lv) na = 32 * g + 32 - __clz(lv);
      }
      if (by_union) ua = cull::warp_union(ua);
      __syncwarp();

      for (int k = 0; 32 * k < na && slot < end; ++k) {
        const Row mine = load_row(sa, 32 * k + lane);
        unsigned am = __ballot_sync(
            FULL, live(mine.lo[0]) && (!by_union || cull::meets(mine, ub)));
        while (am && slot < end) {
          const int r = 32 * k + __ffs(am) - 1;
          am &= am - 1;
          const int i = p * BCHUNK + r;
          const Row a = load_row(sa, r);
          for (int q = self ? i / BCHUNK : 0; q < nbq && slot < end; ++q) {
            if (q != bq) {
              load_chunk(bc, M, q, b);
              bq = q;
            }
            if (kp != p || kq != q) {
              keep = 0;
#pragma unroll
              for (int g = 0; g < BREG; ++g)
                if (__ballot_sync(FULL, by_union ? cull::meets(b[g], ua)
                                                 : live(b[g].lo[0])))
                  keep |= 1u << g;
              kp = p;
              kq = q;
            }
            // Test the row against every group of the chunk, without
            // branches (masks, not skips); rank and write only when some
            // lane hit (most rows hit nothing).
            bool hit[BREG];
            bool any = false;
#pragma unroll
            for (int g = 0; g < BREG; ++g) {
              const int j = q * BCHUNK + 32 * g + lane;
              hit[g] = (keep >> g & 1u) & overlaps(a, b[g]) &
                       (!self | (j > i));
              any |= hit[g];
            }
            if (__any_sync(FULL, any))
              rank_and_write(hit, a.id, b, below, capacity, pairs, slot);
          }
        }
      }
    }
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
// bases int64[h], as (id_a, id_b) int32 pairs into pairs[capacity]; slots
// at or past capacity are not written. n_hit (may be null): the device
// count of the fill's hit tiles, which lead the entries in ascending order
// with bases scanned from every tile's count; entries from it on are not
// read.
extern "C" int grid_emit_launch(const float* bins, int gd, int M, int tile_pad,
                                const long long* tiles, const long long* bases,
                                long long h, const long long* n_hit,
                                long long capacity, int* pairs, void* stream) {
  if (gd < 1 || M < 1 || tile_pad < 14 * gd || h < 0 || !tiles || !bases ||
      (reinterpret_cast<uintptr_t>(bins) & 15) ||
      (reinterpret_cast<uintptr_t>(pairs) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h > 0 && capacity > 0) {
    const long long blocks =
        std::min((h + EMIT_WARPS - 1) / EMIT_WARPS, EMIT_MAX_BLOCKS);
    grid_emit_kernel<<<static_cast<unsigned>(blocks), 32 * EMIT_WARPS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(bins), gd, M, tile_pad, tiles, bases,
        h, n_hit, capacity, reinterpret_cast<int2*>(pairs));
  }
  return static_cast<int>(cudaGetLastError());
}
