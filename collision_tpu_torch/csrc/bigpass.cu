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
// gives each row its first slot, and the emission kernel tests again and
// writes each hit at its rank in the TPU kernel's order: rows ascending,
// chunks in visit order, then word h = 0 before h = 1 (a-rows 0-31, then
// 32-63), lanes ascending, bits ascending. It stages each visited chunk's
// 64 bigs in shared memory, component-major, tests them all with the
// tile test of tile_test.cuh (not culled yet), and one block-wide scan of
// the lanes' popcounts per (chunk, word) gives each thread its slots.
// The TPU kernels' vector accumulator, SMEM scalars, 8-row union ranges
// and sequential pair cursor have no use here and are gone.
//
// Built without --use_fast_math: the test is a compare of floats that the
// plan computed, and must match the CPU bit for bit.

#include "block_scan.cuh"
#include "cull.cuh"
#include "tile_test.cuh"

namespace {

using tile::CHUNK;
using tile::LANE;

constexpr int BIG_COLS = 8;   // big table channels per box
constexpr int WARPS = LANE / 32;

// Big chunk c's 64 boxes, component-major, and their ids, into shared
// memory (coalesced: the chunk is 512 consecutive floats).
__device__ __forceinline__ void load_bigs(const float* __restrict__ bigs,
                                          int c, float (*sa)[CHUNK],
                                          int* __restrict__ sid) {
  const float* rows = bigs + static_cast<long long>(c) * CHUNK * BIG_COLS;
  for (int idx = threadIdx.x; idx < CHUNK * BIG_COLS; idx += blockDim.x) {
    const int r = idx / BIG_COLS, comp = idx % BIG_COLS;
    const float v = rows[idx];
    if (comp < 6) sa[comp][r] = v;
    else if (comp == 6) sid[r] = __float_as_int(v);
  }
}

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

// The set bits of one tile word, ascending, at slots slot, slot + 1, ...
// below capacity: (big id of a-row a0 + bit, the lane's id).
__device__ __forceinline__ void emit_word(uint32_t bits, int a0,
                                          long long slot, int capacity,
                                          const int* __restrict__ sid,
                                          int lane_id, int* __restrict__ ida,
                                          int* __restrict__ idb) {
  for (; bits && slot < capacity; bits &= bits - 1, ++slot) {
    ida[slot] = sid[a0 + __ffs(bits) - 1];
    idb[slot] = lane_id;
  }
}

__global__ void __launch_bounds__(LANE)
big_emit_kernel(const float* __restrict__ bigs, const int* __restrict__ c0,
                const int* __restrict__ c1, int n_always,
                const float* __restrict__ s,
                const long long* __restrict__ bases, int capacity,
                int* __restrict__ ida, int* __restrict__ idb) {
  const int row = blockIdx.x;
  long long cur = bases[row];   // the same in every thread of the block
  if (cur >= capacity) return;
  __shared__ float sa[6][CHUNK];
  __shared__ int sid[CHUNK];
  const int p = row * LANE + threadIdx.x;
  const tile::Box b = tile::load_box(s, p);
  const int lane_id = __float_as_int(tile::stream_comp(s, p, 6));
  const int lo = c0[row], nvis = n_always + (c1[row] - lo);
  for (int t = 0; t < nvis && cur < capacity; ++t) {
    __syncthreads();   // the previous chunk's readers are done
    load_bigs(bigs, visit_chunk(t, n_always, lo), sa, sid);
    __syncthreads();
    const uint32_t w0 = tile::tile_bits(sa, 0, 32, b, false, 0, 0);
    const uint32_t w1 = tile::tile_bits(sa, 32, CHUNK, b, false, 0, 0);
    int n0, n1;
    const int off0 = scan::block_exclusive_scan(__popc(w0), &n0);
    const int off1 = scan::block_exclusive_scan(__popc(w1), &n1);
    emit_word(w0, 0, cur + off0, capacity, sid, lane_id, ida, idb);
    emit_word(w1, 32, cur + n0 + off1, capacity, sid, lane_id, ida, idb);
    cur += n0 + n1;
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

// The pairs of each row at its first slot bases[row]; slots at or past
// capacity are not written.
extern "C" int big_emit_launch(const float* bigs, const int* c0,
                               const int* c1, int n_always, const float* s,
                               int rows, const long long* bases, int capacity,
                               int* ida, int* idb, void* stream) {
  if (rows > 0 && capacity > 0)
    big_emit_kernel<<<rows, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        bigs, c0, c1, n_always, s, bases, capacity, ida, idb);
  return static_cast<int>(cudaGetLastError());
}
