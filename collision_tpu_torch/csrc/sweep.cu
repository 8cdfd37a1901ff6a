// Column sweep kernels: pair count (rolled or aligned window rows) and
// packed pair masks (aligned rows).
//
// Replaces collision_tpu/kernels/sweep.py: _make_rolled_kernel (the
// column engine's count, reached through sweep_count_guarded(rolled=True)),
// _make_kernel (the same count at aligned rows, sweep_count's default) and
// _make_masks_kernel (the masks that fill.mask_fill decodes, reached
// through sweep_masks).
//
// Both kernels run the tile test of column_tile.cuh: a chunk's a-rows and
// their 32-row union boxes in shared memory, a warp's 64 window lanes in
// registers, two exact union-box culls and a test by the sign bits of
// float differences. Left to test after the culls: 32,968,557 lane tests
// on the 1M uniform column plan (rpw 2) of 318,497,478 in its windows,
// 36,834,276 of 493,952,126 on the power-law plan, 517,483,206 of
// 1,179,480,689 on the reference's dense plan (rpw 12).
//
// The count stores nothing but its total (column_tile.cuh's count_block,
// which the slab count shares): a window's lanes are one index range,
// walked in 64-lane segments that each lie in one stream row, the
// block's warps taking the (offset, segment) units of its five windows
// in turn. A thread sums the popcounts of its words in an int (a block
// counts at most 64 x 5 x rpw*128: an int holds it up to rpw 128, the top
// of the ladder); the block adds one integer atomic, so the total is
// deterministic. Its bytes are the stream and the tables, read once, with
// window re-reads that stay in the 50 MB L2: 0.0102 ms at 1M. On an H100
// it takes about ten times that, held neither by those bytes nor by its
// tests (0.003 ms of float adds) but by each block's chain of latencies
// at 64 registers a thread (8 blocks an SM): the chunk's staging and a
// barrier, then per unit the lane loads, a warp union, the two culls'
// ballots and the survivors' shared loads. Both halves of a unit run
// unrolled, for more to issue; scratch builds that prefetched the next
// unit's lanes (80 registers), capped registers at 40 (spills), skipped
// the loads of lanes outside the range, or moved the dense threshold
// were no faster.
//
// The masks: on the reference's dense plan the masks are 0.87 GB, two
// thirds of it the zeros of dead chunk slots, and the kernel is still
// bound by its tests, not its stores. Block x = column * (ng * kg) +
// chunk slot kq writes the slot's NOFF*rpw*2 rows of 128 words (the JAX
// masks' layout: row (off*rpw + r)*2 + h, word l = stream lane l of
// window row r, bit t = a-row h*32 + t). Every word is written: slots
// past mc and dead chunks write zeros, 16 bytes a store. Its warps take
// the (offset, row, segment) units; a thread writes its two lanes' words
// of each half with one 8-byte store, and a segment outside the window
// writes zeros and loads nothing. The self offset's j > i and the window
// are one mask a word. (On an H100, six compares in place of the sign-bit
// test, the rest the same, are 1-4% slower on the dense, 1M and power-law
// plans. Four lanes a thread, 16-byte
// loads and stores and a 128-lane union, was as fast on the dense plan
// and slower on the 1M and power-law plans; one lane a thread slower on
// the dense plan.)
//
// rpw is a runtime loop bound. The TPU kernel's slab DMA ring, lane
// rolls, chunk-pair transposes and unrolling have no use here and are
// gone.
//
// Built without --use_fast_math: the tests compare floats that the plan
// computed, or take their exact differences, which flushing subnormals
// to zero would break, and must match the CPU bit for bit.

#include "column_tile.cuh"

namespace {

using column::LPT;
using column::SEG;
using stream::CHUNK;
using stream::LANE;

constexpr int NOFF = 5;   // columns.COLUMN_OFFSETS

// Block x = column * mc + chunk: one grid dimension, so gxy^2 * mc is the
// only bound on the grid. ROLLED picks the end of each window's range.
template <bool ROLLED>
__global__ void __launch_bounds__(LANE)
column_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                    const int* __restrict__ w0, const int* __restrict__ wcap,
                    int mc, int rpw, unsigned long long* __restrict__ total) {
  column::count_block<NOFF, ROLLED, false>(s, starts, w0, wcap, mc, rpw, 0, 0,
                                           blockIdx.x / mc, blockIdx.x % mc,
                                           total);
}

__global__ void __launch_bounds__(LANE)
column_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                    const int* __restrict__ w0, const int* __restrict__ wcap,
                    int mc, int rpw, int kg, int ng,
                    uint32_t* __restrict__ out) {
  const int slots = ng * kg;
  const int b = blockIdx.x / slots, kq = blockIdx.x % slots;
  const int nrows = NOFF * rpw * 2;
  uint32_t* rows = out + ((static_cast<long long>(b) * ng + kq / kg) * kg
                          + kq % kg) * nrows * LANE;
  const int a1 = starts[b + 1];
  const int g0 = starts[b] + kq * CHUNK;
  const int alen = kq < mc ? max(0, min(a1 - g0, CHUNK)) : 0;
  if (alen == 0) {
    uint4* o = reinterpret_cast<uint4*>(rows);
    for (int i = threadIdx.x; i < nrows * LANE / 4; i += LANE)
      o[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  __shared__ float4 slo[CHUNK], shi[CHUNK];
  __shared__ cull::Box half_union[2];
  __shared__ int win[NOFF][2];   // the offsets' window starts and lengths
  if (threadIdx.x < CHUNK) {     // warps 0 and 1: the two halves
    column::stage_chunk(s, g0, alen, slo, shi, half_union);
  } else if (threadIdx.x < CHUNK + NOFF) {
    const long long e = (static_cast<long long>(b) * mc + kq) * NOFF
                        + threadIdx.x - CHUNK;
    win[threadIdx.x - CHUNK][0] = w0[e];
    win[threadIdx.x - CHUNK][1] = wcap[e];
  }
  __syncthreads();

  constexpr int ROW_SEGS = LANE / SEG;   // warp units a window row
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  for (int unit = warp; unit < NOFF * rpw * ROW_SEGS; unit += LANE / 32) {
    const int item = unit / ROW_SEGS, off = item / rpw, r = item % rpw;
    const int w = win[off][0], wc = win[off][1];
    const int srow = w / LANE + r;                        // stream row
    const int l0 = (unit % ROW_SEGS) * SEG + lt * LPT;    // first lane
    const int j0 = srow * LANE + l0;
    uint2* row = reinterpret_cast<uint2*>(rows + (off * rpw + r) * 2 * LANE
                                          + l0);
    const int seg0 = j0 - lt * LPT;   // the warp's segment, uniform
    if (wc == 0 || seg0 >= w + wc || seg0 + SEG <= w) {
      row[0] = make_uint2(0u, 0u);
      row[LANE / LPT] = make_uint2(0u, 0u);
      continue;
    }
    cull::Box wu;
    const column::Lanes t = column::load_lanes(s, j0, w, w + wc, &wu);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const float4* al = slo + h * 32;
      const float4* ah = shi + h * 32;
      // A register copy of the half's union: with the cull reading it
      // from shared memory, ptxas gave this body 72 registers, not 67,
      // and it ran slower on an H100.
      const cull::Box hu = half_union[h];
      uint32_t word[LPT], keep[LPT];
      column::test_rows(al, ah,
                        column::survivors(al, ah, hu, wu, t,
                                          off == 0, j0 - g0 - 32 * h, keep),
                        t, word);
      row[h * LANE / LPT] = make_uint2(word[0] & keep[0], word[1] & keep[1]);
    }
  }
}

}  // namespace

extern "C" int sweep_count_launch(const float* s, const int* starts,
                                  const int* w0, const int* wcap, int ncols,
                                  int mc, int rpw, int rolled,
                                  unsigned long long* total, void* stream) {
  const long long blocks = static_cast<long long>(ncols) * mc;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0 && rpw > 0) {
    auto st = static_cast<cudaStream_t>(stream);
    if (rolled)
      column_count_kernel<true><<<static_cast<unsigned>(blocks), LANE, 0, st>>>(
          s, starts, w0, wcap, mc, rpw, total);
    else
      column_count_kernel<false><<<static_cast<unsigned>(blocks), LANE, 0, st>>>(
          s, starts, w0, wcap, mc, rpw, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sweep_masks_launch(const float* s, const int* starts,
                                  const int* w0, const int* wcap, int ncols,
                                  int mc, int rpw, int kg, int ng,
                                  uint32_t* out, void* stream) {
  // The vector loads and stores need 16-byte aligned stream and masks.
  const long long blocks = static_cast<long long>(ncols) * ng * kg;
  if (blocks > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0 && rpw > 0)
    column_masks_kernel<<<static_cast<unsigned>(blocks), LANE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        s, starts, w0, wcap, mc, rpw, kg, ng, out);
  return static_cast<int>(cudaGetLastError());
}
