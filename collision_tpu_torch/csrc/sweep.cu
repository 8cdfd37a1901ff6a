// Column sweep kernels: pair count (rolled or aligned window rows) and
// packed pair masks (aligned rows).
//
// Replaces collision_tpu/kernels/sweep.py: _make_rolled_kernel (the
// column engine's count, reached through sweep_count_guarded(rolled=True)),
// _make_kernel (the same count at aligned rows, sweep_count's default) and
// _make_masks_kernel (the masks that fill.mask_fill decodes, reached
// through sweep_masks).
//
// The count: one 128-thread block per (column, chunk) with the tile test
// of tile_test.cuh; a lane outside its window loads nothing and tests
// nothing, so the mostly empty second row of a rolled window costs a
// branch, not 64 tests. At 1M uniform spheres (gxy=26, ~15.6k live
// chunks, rpw=2) that is at most ~1.3G tests, while the bytes read are
// the 32 MB stream plus window re-reads that stay in the 50 MB L2: bound
// by instruction throughput, not by HBM. The count adds one integer atomic
// per block, so the total is deterministic.
//
// The masks: on the reference's dense plan (307200 spheres, rpw 12) the
// window holds 1.18G tests and the masks are 0.87 GB, two thirds of it
// the zeros of dead chunk slots. With the tile test's six 4-byte shared
// loads a test, the kernel was bound by shared-load throughput (~7G lane
// loads), and then by its float compares, which run at half rate. Its
// own body (column_masks_kernel) reads an a-row with two 16-byte
// broadcast loads for two window lanes a thread, tests only what two
// exact culls leave (a lane against a mask word's union box, an a-row
// against the warp's lanes' union box; 0.52G lane tests are left on the
// dense plan), and tests with float adds and ands.
//
// rpw is a runtime loop bound. The TPU kernel's slab DMA ring, lane
// rolls, chunk-pair transposes and unrolling have no use here and are
// gone.
//
// Built without --use_fast_math: the tests compare floats that the plan
// computed, or take their exact differences, which flushing subnormals
// to zero would break, and must match the CPU bit for bit.

#include "cull.cuh"
#include "tile_test.cuh"

namespace {

using tile::CHUNK;
using tile::LANE;

constexpr int NOFF = 5;   // columns.COLUMN_OFFSETS

// Block x = column * mc + chunk: one grid dimension, so gxy^2 * mc is the
// only bound on the grid.
template <bool ROLLED>
__global__ void __launch_bounds__(LANE)
column_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                    const int* __restrict__ w0, const int* __restrict__ wcap,
                    int mc, int rpw, unsigned long long* __restrict__ total) {
  tile::count_chunk<NOFF, ROLLED>(s, starts, w0, wcap, mc, rpw, 0, 0,
                                  blockIdx.x / mc, blockIdx.x % mc, total);
}

// The masks: block x = column * (ng * kg) + chunk slot kq, which writes
// the slot's NOFF*rpw*2 rows of 128 words (tile::masks_chunk's layout:
// row (off*rpw + r)*2 + h, word l = window lane l of row r, bit t =
// a-row h*32 + t). Every word is written: slots past mc and dead chunks
// write zeros, 16 bytes a store.
//
// A live chunk's 64 a-rows go to shared memory as two float4 each (lo
// xyz + pad, hi xyz + pad), with the union box of each 32-row half, the
// rows of one mask word (cull.cuh), and its five windows. The block's
// warps then take the (offset, row, 64-lane segment) units in turn: a
// thread holds LPT = 2 neighbouring window lanes of one row in registers
// (one 8-byte load a component) and writes their two words of each half
// with one 8-byte store; a segment outside the window writes zeros and
// loads nothing. Two exact culls (cull.cuh) pick the tests a warp runs
// for a half: none unless one of its lanes meets the half's union box,
// and then only the a-rows that meet the union of its 64 lanes, the
// survivors; each survivor's two broadcast 16-byte loads serve two
// tests. With DENSE_SURVIVORS or more the warp tests all 32 a-rows in
// an unrolled loop instead, without the survivor loop's bookkeeping.
// The self offset's j > i and the window are one mask a word.
//
// The test runs no float compare, which runs at half rate: a < b iff
// the sign bit of a - b is set, for a and b free of -0, which x + 0.0f
// turns into +0. A nonzero exact difference is never rounded to zero,
// x - x is +0, and the card's float add returns the NaN 0x7fffffff, sign
// clear, for a NaN operand and for inf - inf (equal infinities, where a
// < b is false). So a pair overlaps iff the six differences b.lo - a.hi
// and a.lo - b.hi share a set sign bit: six float adds and three ands.
// (On an H100, six compares in their place, the rest the same, are 1-4%
// slower on the dense, 1M and power-law plans: masks_variants.py times
// both.)
//
// (On an H100 the kernel is bound by those tests, not by its stores:
// four lanes a thread, 16-byte loads and stores and a 128-lane union,
// was as fast on the dense plan and slower on the 1M and power-law
// plans; one lane a thread slower on the dense plan.)
constexpr int LPT = 2;                     // window lanes a thread
constexpr int SEG = LANE / (32 * LPT);     // warp units a window row
constexpr int DENSE_SURVIVORS = 20;

__device__ __forceinline__ uint32_t below_mask(int k) {   // bits [0, k)
  return k <= 0 ? 0u : k >= 32 ? ~0u : (1u << k) - 1u;
}

// The sign bit of x - y: set iff x < y, for x and y free of -0.
__device__ __forceinline__ uint32_t less(float x, float y) {
  return __float_as_uint(x - y);
}

// Sign bit set iff a-row (a, c) = (lo, hi) overlaps lane i.
__device__ __forceinline__ uint32_t overlap(const float4& a, const float4& c,
                                            const float (&lo)[3][LPT],
                                            const float (&hi)[3][LPT],
                                            int i) {
  return less(lo[0][i], c.x) & less(a.x, hi[0][i]) &
         less(lo[1][i], c.y) & less(a.y, hi[1][i]) &
         less(lo[2][i], c.z) & less(a.z, hi[2][i]);
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
    const int r = threadIdx.x;
    cull::Box a = cull::empty();
    if (r < alen) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a.lo[c] = tile::stream_comp(s, g0 + r, c) + 0.0f;
        a.hi[c] = tile::stream_comp(s, g0 + r, c + 3) + 0.0f;
      }
    }
    slo[r] = make_float4(a.lo[0], a.lo[1], a.lo[2], 0.0f);
    shi[r] = make_float4(a.hi[0], a.hi[1], a.hi[2], 0.0f);
    cull::Box u = cull::empty();
    cull::add(u, a);
    u = cull::warp_union(u);
    if ((r & 31) == 0) half_union[r >> 5] = u;
  } else if (threadIdx.x < CHUNK + NOFF) {
    const long long e = (static_cast<long long>(b) * mc + kq) * NOFF
                        + threadIdx.x - CHUNK;
    win[threadIdx.x - CHUNK][0] = w0[e];
    win[threadIdx.x - CHUNK][1] = wcap[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  for (int unit = warp; unit < NOFF * rpw * SEG; unit += LANE / 32) {
    const int item = unit / SEG, off = item / rpw, r = item % rpw;
    const int w = win[off][0], wc = win[off][1];
    const int srow = w / LANE + r;                       // stream row
    const int l0 = (unit % SEG) * 32 * LPT + lt * LPT;   // first lane
    const int j0 = srow * LANE + l0;
    uint2* row = reinterpret_cast<uint2*>(rows + (off * rpw + r) * 2 * LANE
                                          + l0);
    const int seg0 = j0 - lt * LPT;   // the warp's segment, uniform
    if (wc == 0 || seg0 >= w + wc || seg0 + 32 * LPT <= w) {
      row[0] = make_uint2(0u, 0u);
      row[LANE / LPT] = make_uint2(0u, 0u);
      continue;
    }
    // The lanes' boxes, component-major, and the union of those in the
    // window.
    float lo[3][LPT], hi[3][LPT];
    const float* p = s + static_cast<long long>(srow) * 8 * LANE + l0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(p + c * LANE);
      const float2 h = *reinterpret_cast<const float2*>(p + (c + 3) * LANE);
      lo[c][0] = l.x + 0.0f;
      lo[c][1] = l.y + 0.0f;
      hi[c][0] = h.x + 0.0f;
      hi[c][1] = h.y + 0.0f;
    }
    uint32_t in_window[LPT];
    cull::Box wu = cull::empty();
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const bool in = (j0 + i >= w) & (j0 + i < w + wc);
      in_window[i] = in ? ~0u : 0u;
      if (in) {
        cull::Box l;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          l.lo[c] = lo[c][i];
          l.hi[c] = hi[c][i];
        }
        cull::add(wu, l);
      }
    }
    wu = cull::warp_union(wu);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const cull::Box u = half_union[h];
      uint32_t word[LPT], keep[LPT];
      bool need = false;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        word[i] = 0u;
        keep[i] = in_window[i] &
                  (off == 0 ? below_mask(j0 + i - g0 - 32 * h) : ~0u);
        need |= keep[i] != 0u &&
                (u.hi[0] > lo[0][i]) & (u.lo[0] < hi[0][i]) &
                (u.hi[1] > lo[1][i]) & (u.lo[1] < hi[1][i]) &
                (u.hi[2] > lo[2][i]) & (u.lo[2] < hi[2][i]);
      }
      // The survivors: this half's a-rows that meet the lanes' union.
      const float4* al = slo + h * 32;
      const float4* ah = shi + h * 32;
      const float4 ml = al[lt], mh = ah[lt];
      const bool meets = (mh.x > wu.lo[0]) & (ml.x < wu.hi[0]) &
                         (mh.y > wu.lo[1]) & (ml.y < wu.hi[1]) &
                         (mh.z > wu.lo[2]) & (ml.z < wu.hi[2]);
      uint32_t surv = __ballot_sync(cull::FULL, meets);
      if (!__any_sync(cull::FULL, need)) surv = 0u;
      if (__popc(surv) >= DENSE_SURVIVORS) {
        // Every a-row, bit 31 first: each result shifts in at bit 0.
#pragma unroll 8
        for (int t = 31; t >= 0; --t) {
          const float4 a = al[t], c = ah[t];
#pragma unroll
          for (int i = 0; i < LPT; ++i)
            word[i] = __funnelshift_l(overlap(a, c, lo, hi, i), word[i], 1);
        }
      } else {
        for (; surv; surv &= surv - 1) {
          const int t = __ffs(surv) - 1;
          const float4 a = al[t], c = ah[t];
#pragma unroll
          for (int i = 0; i < LPT; ++i)
            word[i] |= (overlap(a, c, lo, hi, i) & 0x80000000u) >> (31 - t);
        }
      }
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
