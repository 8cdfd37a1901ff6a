// Big-sphere pass: the hetero engine's big set against every stream row.
//
// Replaces collision_tpu/kernels/bigpass.py: _make_big_count_kernel (the
// count, reached through big_count_only) and _make_big_kernel (the pairs,
// reached through big_pairs).
//
// The big set is a table of nbc chunks of 64 boxes (f32[nbc, 64, 8]:
// xlo ylo zlo xhi yhi zhi id-bits pad). Stream row r is tested against
// chunks 0..n_always-1 (the giants) and then against its own z-gated range
// [c0[r], c1[r]), with the strict test a.hi > b.lo && a.lo < b.hi on each
// axis, a = big, b = stream lane. Parked bigs in the stream ([+inf, -inf]
// boxes) and all-+inf pad rows and lanes fail it.
//
// What bounds it on the H100. At 1M power-law spheres (~8k stream rows,
// each visiting the giant chunk and ~4 z-gated chunks) every big against
// every lane is ~333M tests, but a row spans one column (1/26) or one
// slab (1/146) in x, so most bigs of a visited chunk cannot meet any of
// its lanes. The tests the inputs need are a few M: the count is bound
// by the bytes it reads, the 33 MB stream once (the big table stays in
// L2).
//
// What the design does about it. The count: one 128-thread block per
// stream row, each thread holding its lane's box in registers. The
// block forms the row's union box (a row with no live lane writes 0 and
// leaves), tests each visited big against it (cull.cuh: exact), stages
// only the survivors in shared memory, ranked by warp ballots, and each
// thread tests its lane against them with two broadcast 16-byte loads a
// test. The count writes each row's int32 count and adds it to one
// integer total with an atomic, so the result is deterministic.
//
// The pairs take two passes: that count, then an exclusive scan of the
// row counts on the stream (the wrapper's torch.cumsum, no host sync)
// gives each row its first slot, and the emission kernel writes each hit
// at its rank in the TPU kernel's order: rows ascending, chunks in visit
// order, then word h = 0 before h = 1 (a-rows 0-31, then 32-63), lanes
// ascending, bits ascending. It skips the rows the count found empty and
// culls the visited bigs against the row's union box as the count does;
// a mask word with no survivor costs no test and no scan, and the
// survivors keep their bit positions, so the order is the TPU kernel's.
// One block-wide scan of the lanes' popcounts per surviving word gives
// each thread its slots. The TPU kernels' vector accumulator, SMEM
// scalars, 8-row union ranges and sequential pair cursor have no use
// here and are gone.
//
// Built without --use_fast_math: the test is a compare of floats that the
// plan computed, and must match the CPU bit for bit.

#include "block_scan.cuh"
#include "cull.cuh"
#include "tile_test.cuh"

namespace {

using tile::CHUNK;
using tile::LANE;

constexpr int WARPS = LANE / 32;

// Chunk t of a row's visit list: the giants 0..n_always-1, then c0..c1-1.
__device__ __forceinline__ int visit_chunk(int t, int n_always, int c0) {
  return t < n_always ? t : c0 + (t - n_always);
}

// Row r's count. The row's union box over its live lanes comes first (a
// row with none writes 0 and leaves). Then its visited bigs go in rounds
// of 128, one a thread: each is tested against the union, the survivors
// are ranked by ballots and staged in shared memory as two float4 (lo
// xyz + id bits, hi xyz + pad), and every thread tests its lane against
// the survivors, two broadcast 16-byte loads a test. Two barriers a
// round. (Rounds of 256 and 512 bigs, two and four a thread, took 3%
// and 22% longer on the 1M power-law plan on an H100.)
__global__ void __launch_bounds__(LANE)
big_count_kernel(const float* __restrict__ bigs, const int* __restrict__ c0,
                 const int* __restrict__ c1, int n_always,
                 const float* __restrict__ s, int* __restrict__ counts,
                 unsigned long long* __restrict__ total) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  __shared__ float4 sv[2 * LANE];      // the round's survivors
  __shared__ cull::Box wu[WARPS];      // each warp's part of the row union
  __shared__ int wlive[WARPS];
  __shared__ int wkeep[WARPS];
  const tile::Box b = tile::load_box(s, row * LANE + threadIdx.x);
  cull::Box u = cull::empty();
  cull::add(u, b);
  u = cull::warp_union(u);
  const unsigned lv = __ballot_sync(cull::FULL, cull::live(b.lo[0]));
  if (lane == 0) {
    wu[warp] = u;
    wlive[warp] = lv != 0;
  }
  __syncthreads();
  int nlive = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    nlive += wlive[w];
    cull::merge(u, wu[w]);
  }
  if (nlive == 0) {   // the same in every thread: no lane can meet a big
    if (counts && threadIdx.x == 0) counts[row] = 0;
    return;
  }

  const int lo = c0[row];
  const int nv = (n_always + (c1[row] - lo)) * CHUNK;   // bigs visited
  const float4* rows = reinterpret_cast<const float4*>(bigs);
  int hits = 0;
  for (int v0 = 0; v0 < nv; v0 += LANE) {
    // The cull: big v of the visit list against the row's union.
    const int v = v0 + threadIdx.x;
    float4 slo, shi;
    bool in = false;
    if (v < nv) {
      const long long r = static_cast<long long>(
          visit_chunk(v / CHUNK, n_always, lo)) * CHUNK + v % CHUNK;
      const float4 p = rows[2 * r], q = rows[2 * r + 1];
      // xlo ylo zlo xhi | yhi zhi id pad
      tile::Box a;
      a.lo[0] = p.x; a.lo[1] = p.y; a.lo[2] = p.z;
      a.hi[0] = p.w; a.hi[1] = q.x; a.hi[2] = q.y;
      in = cull::meets(a, u);
      slo = make_float4(p.x, p.y, p.z, q.z);
      shi = make_float4(p.w, q.x, q.y, q.w);
    }
    const unsigned keep = __ballot_sync(cull::FULL, in);
    if (lane == 0) wkeep[warp] = __popc(keep);
    __syncthreads();   // the last round's readers are done
    int at = __popc(keep & below), ns = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? wkeep[w] : 0;
      ns += wkeep[w];
    }
    if (in) {
      sv[2 * at] = slo;
      sv[2 * at + 1] = shi;
    }
    __syncthreads();
    // The tests: a = survivor, b = the lane.
    for (int i = 0; i < ns; ++i) {
      const float4 l = sv[2 * i], h = sv[2 * i + 1];
      hits += (h.x > b.lo[0]) & (l.x < b.hi[0]) & (h.y > b.lo[1]) &
              (l.y < b.hi[1]) & (h.z > b.lo[2]) & (l.z < b.hi[2]);
    }
  }
  int row_hits;
  scan::block_exclusive_scan(hits, &row_hits);
  if (threadIdx.x == 0) {
    if (counts) counts[row] = row_hits;
    if (total && row_hits)
      atomicAdd(total, static_cast<unsigned long long>(row_hits));
  }
}

// Row r's pairs, from its first slot bases[r], in the TPU kernel's
// order. A row with no pair (counts[r] == 0) or whose first slot is past
// capacity leaves at once. Its visited bigs go in rounds of 128, one a
// thread, as in the count: each is tested against the row's union box,
// a ballot per warp gives the survivors of one 32-big mask word (round
// word w = visit words 4*round + w: chunks in visit order, h = 0 before
// h = 1), and the survivors are staged at their own positions, two
// float4 each, in one of two buffers (so one barrier a round). A word
// with no survivor is skipped by the whole block. For the others each
// thread tests its lane against the word's survivors in bit order, two
// broadcast 16-byte loads a test, and one block-wide scan of the lanes'
// popcounts gives each thread its slots: lanes ascending, bits
// ascending. The cull drops only tests that fail, so at every capacity
// the buffers are those of a kernel that tests every visited big.
__global__ void __launch_bounds__(LANE)
big_emit_kernel(const float* __restrict__ bigs, const int* __restrict__ c0,
                const int* __restrict__ c1, int n_always,
                const float* __restrict__ s, const int* __restrict__ counts,
                const long long* __restrict__ bases, int capacity,
                int* __restrict__ ida, int* __restrict__ idb) {
  const int row = blockIdx.x;
  long long cur = bases[row];   // the same in every thread of the block
  if (counts[row] == 0 || cur >= capacity) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float4 sv[2][2 * LANE];   // two rounds' survivors
  __shared__ unsigned skeep[2][WARPS];
  __shared__ cull::Box wu[WARPS + 1];  // the warps' unions, the row's
  const int p = row * LANE + threadIdx.x;
  const tile::Box b = tile::load_box(s, p);
  {
    cull::Box u = cull::empty();
    cull::add(u, b);
    u = cull::warp_union(u);
    if (lane == 0) wu[warp] = u;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int w = 1; w < WARPS; ++w) cull::merge(u, wu[w]);
      wu[WARPS] = u;
    }
    __syncthreads();
  }
  const cull::Box& u = wu[WARPS];   // read where it is needed

  const int lo = c0[row];
  const int nv = (n_always + (c1[row] - lo)) * CHUNK;   // bigs visited
  const float4* rows = reinterpret_cast<const float4*>(bigs);
  for (int v0 = 0, buf = 0; v0 < nv && cur < capacity; v0 += LANE, buf ^= 1) {
    const int v = v0 + threadIdx.x;
    bool in = false;
    if (v < nv) {
      const long long r = static_cast<long long>(
          visit_chunk(v / CHUNK, n_always, lo)) * CHUNK + v % CHUNK;
      const float4 pl = rows[2 * r], ql = rows[2 * r + 1];
      // xlo ylo zlo xhi | yhi zhi id pad
      tile::Box a;
      a.lo[0] = pl.x; a.lo[1] = pl.y; a.lo[2] = pl.z;
      a.hi[0] = pl.w; a.hi[1] = ql.x; a.hi[2] = ql.y;
      in = cull::meets(a, u);
      if (in) {
        sv[buf][2 * threadIdx.x] = make_float4(pl.x, pl.y, pl.z, ql.z);
        sv[buf][2 * threadIdx.x + 1] = make_float4(pl.w, ql.x, ql.y, ql.w);
      }
    }
    const unsigned keep = __ballot_sync(cull::FULL, in);
    if (lane == 0) skeep[buf][warp] = keep;
    __syncthreads();   // publishes the round; the round before last is read
    for (int w = 0; w < WARPS && cur < capacity; ++w) {
      const unsigned k = skeep[buf][w];
      if (k == 0u) continue;   // the same in every thread
      const float4* word = sv[buf] + 2 * 32 * w;
      uint32_t bits = 0u;
      for (unsigned m = k; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        const float4 l = word[2 * t], h = word[2 * t + 1];
        const bool hit = (h.x > b.lo[0]) & (l.x < b.hi[0]) &
                         (h.y > b.lo[1]) & (l.y < b.hi[1]) &
                         (h.z > b.lo[2]) & (l.z < b.hi[2]);
        bits |= static_cast<uint32_t>(hit) << t;
      }
      int n;
      long long slot = cur + scan::block_exclusive_scan(__popc(bits), &n);
      for (; bits && slot < capacity; bits &= bits - 1, ++slot) {
        ida[slot] = __float_as_int(word[2 * (__ffs(bits) - 1)].w);
        idb[slot] = __float_as_int(tile::stream_comp(s, p, 6));
      }
      cur += n;
    }
  }
}

}  // namespace

// Row counts (counts may be null) and/or their sum added to *total (may be
// null) of the rows [0, rows) of the stream.
extern "C" int big_count_launch(const float* bigs, const int* c0,
                                const int* c1, int n_always, const float* s,
                                int rows, int* counts,
                                unsigned long long* total, void* stream) {
  if (reinterpret_cast<uintptr_t>(bigs) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0)
    big_count_kernel<<<rows, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        bigs, c0, c1, n_always, s, counts, total);
  return static_cast<int>(cudaGetLastError());
}

// The pairs of each row at its first slot bases[row], from the count
// pass's row counts; slots at or past capacity are not written.
extern "C" int big_emit_launch(const float* bigs, const int* c0,
                               const int* c1, int n_always, const float* s,
                               int rows, const int* counts,
                               const long long* bases, int capacity,
                               int* ida, int* idb, void* stream) {
  if (reinterpret_cast<uintptr_t>(bigs) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && capacity > 0)
    big_emit_kernel<<<rows, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        bigs, c0, c1, n_always, s, counts, bases, capacity, ida, idb);
  return static_cast<int>(cudaGetLastError());
}
