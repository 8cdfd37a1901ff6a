// The sweep kernels' tile test, shared by the column count and masks
// kernels (sweep.cu) and the slab count and masks kernels (slab_sweep.cu).
//
// A block stages one 64-sphere a-chunk of a column in shared memory: each
// a-row as two float4 (lo xyz + pad, hi xyz + pad), and the union box of
// each 32-row half, the a-rows of one mask word (cull.cuh). A warp then
// takes 64 window lanes, a segment: each thread holds LPT = 2 neighbouring
// lanes in registers (one 8-byte load a component in a segment that lies
// in one [8, 128] stream row from a multiple of 64; two 4-byte loads in
// a rolled row of the slab masks, which may start anywhere). Two exact
// culls pick the tests a warp runs for a
// half: none unless one of its lanes meets the half's union box, and then
// only the a-rows that meet the union of its lanes, the survivors; each
// survivor's two broadcast 16-byte loads serve two tests. With
// DENSE_SURVIVORS or more the warp tests all 32 a-rows in an unrolled
// loop instead, without the survivor loop's bookkeeping.
//
// The test runs no float compare, which runs at half rate: a < b iff the
// sign bit of a - b is set, for a and b free of -0, which x + 0.0f turns
// into +0. A nonzero exact difference is never rounded to zero, x - x is
// +0, and the card's float add returns the NaN 0x7fffffff, sign clear,
// for a NaN operand and for inf - inf (equal infinities, where a < b is
// false). So a pair overlaps iff the six differences b.lo - a.hi and
// a.lo - b.hi share a set sign bit: six float adds and three ands.
#pragma once

#include "cull.cuh"
#include "stream.cuh"

namespace column {

using stream::CHUNK;
using stream::LANE;

constexpr int LPT = 2;                  // window lanes a thread
constexpr int SEG = 32 * LPT;           // window lanes a warp, a segment
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

// Run by threads 0 .. CHUNK-1 (warps 0 and 1, one half each): a-row r =
// threadIdx.x of the chunk at g0 into slo / shi, +0 for -0, rows from
// alen on as the empty box; each half's union box into half_union.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ s,
                                            int g0, int alen, float4* slo,
                                            float4* shi,
                                            cull::Box* half_union) {
  const int r = threadIdx.x;
  cull::Box a = cull::empty();
  if (r < alen) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.lo[c] = stream::comp(s, g0 + r, c) + 0.0f;
      a.hi[c] = stream::comp(s, g0 + r, c + 3) + 0.0f;
    }
  }
  slo[r] = make_float4(a.lo[0], a.lo[1], a.lo[2], 0.0f);
  shi[r] = make_float4(a.hi[0], a.hi[1], a.hi[2], 0.0f);
  cull::Box u = cull::empty();
  cull::add(u, a);
  u = cull::warp_union(u);
  if ((r & 31) == 0) half_union[r >> 5] = u;
}

// A thread's window lanes: their boxes, component-major, +0 for -0, and
// which lie in the window range.
struct Lanes {
  float lo[3][LPT], hi[3][LPT];
  uint32_t in[LPT];   // ~0u for a lane in the range, else 0
};

// The boxes of lanes j0 and j0 + 1 (j0 even: one stream row), one
// 8-byte load a component.
__device__ __forceinline__ void load_pair(const float* __restrict__ s,
                                          int j0, Lanes& t) {
  const float* p = s + static_cast<long long>(j0 / LANE) * 8 * LANE
                   + j0 % LANE;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(p + c * LANE);
    const float2 h = *reinterpret_cast<const float2*>(p + (c + 3) * LANE);
    t.lo[c][0] = l.x + 0.0f;
    t.lo[c][1] = l.y + 0.0f;
    t.hi[c][0] = h.x + 0.0f;
    t.hi[c][1] = h.y + 0.0f;
  }
}

// The boxes of lanes 0 and 1 from positions j0 and j1 (any two, in
// either stream row), one 4-byte load a component each.
__device__ __forceinline__ void load_apart(const float* __restrict__ s,
                                           int j0, int j1, Lanes& t) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.lo[c][0] = stream::comp(s, j0, c) + 0.0f;
    t.lo[c][1] = stream::comp(s, j1, c) + 0.0f;
    t.hi[c][0] = stream::comp(s, j0, c + 3) + 0.0f;
    t.hi[c][1] = stream::comp(s, j1, c + 3) + 0.0f;
  }
}

// Which of lanes j0 .. j0 + LPT - 1 lie in the range [js, je), and the
// union box, in every lane of the warp, of the warp's lanes in it.
__device__ __forceinline__ void in_range(Lanes& t, int j0, int js, int je,
                                         cull::Box* wu) {
  cull::Box u = cull::empty();
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool in = (j0 + i >= js) & (j0 + i < je);
    t.in[i] = in ? ~0u : 0u;
    if (in) {
      cull::Box l;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        l.lo[c] = t.lo[c][i];
        l.hi[c] = t.hi[c][i];
      }
      cull::add(u, l);
    }
  }
  *wu = cull::warp_union(u);
}

// Lanes j0 .. j0 + LPT - 1 (j0 a multiple of LPT; the warp's segment
// inside one stream row) and the union of the warp's lanes in [js, je).
__device__ __forceinline__ Lanes load_lanes(const float* __restrict__ s,
                                            int j0, int js, int je,
                                            cull::Box* wu) {
  Lanes t;
  load_pair(s, j0, t);
  in_range(t, j0, js, je, wu);
  return t;
}

// The same for lanes of a rolled window row [js, je), whose words start
// at js: j0 >= js of either parity, so a lane pair may span two stream
// rows, and each lane is loaded on its own (on an H100 no slower than
// one 8-byte load a component where j0 is even: masks_variants.py).
// Lanes from je on are read at je - 1, inside the stream, and stay out
// of the range.
__device__ __forceinline__ Lanes load_rolled_lanes(
    const float* __restrict__ s, int j0, int js, int je, cull::Box* wu) {
  Lanes t;
  load_apart(s, min(j0, je - 1), min(j0 + 1, je - 1), t);
  in_range(t, j0, js, je, wu);
  return t;
}

// The a-rows of one half that a warp tests, the survivors (whole warp):
// none unless one of its lanes meets the half's union box hu, and then
// those that meet the lanes' union wu (load_lanes). A lane takes part
// only where keep[i], which this sets, holds a bit: in the range and,
// where ``masked`` (the self offset; every offset of a pass with a
// minimum index distance dmin), past an a-row of the half by more than
// dmin (bit r iff r < k + i, k = j0 - (first a-row of the half) - dmin).
// al / ah: the half's a-rows.
__device__ __forceinline__ uint32_t survivors(const float4* al,
                                              const float4* ah,
                                              const cull::Box hu,
                                              const cull::Box& wu,
                                              const Lanes& t, bool masked,
                                              int k, uint32_t (&keep)[LPT]) {
  bool need = false;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    keep[i] = t.in[i] & (masked ? below_mask(k + i) : ~0u);
    need |= keep[i] != 0u &&
            (hu.hi[0] > t.lo[0][i]) & (hu.lo[0] < t.hi[0][i]) &
            (hu.hi[1] > t.lo[1][i]) & (hu.lo[1] < t.hi[1][i]) &
            (hu.hi[2] > t.lo[2][i]) & (hu.lo[2] < t.hi[2][i]);
  }
  const int lt = threadIdx.x & 31;
  const float4 ml = al[lt], mh = ah[lt];
  const bool meets = (mh.x > wu.lo[0]) & (ml.x < wu.hi[0]) &
                     (mh.y > wu.lo[1]) & (ml.y < wu.hi[1]) &
                     (mh.z > wu.lo[2]) & (ml.z < wu.hi[2]);
  const uint32_t surv = __ballot_sync(cull::FULL, meets);
  return __any_sync(cull::FULL, need) ? surv : 0u;
}

// The tile words of the survivors: bit r of word[i] set iff a-row r of
// the half (al[r], ah[r]) overlaps lane i, for each r in surv; the bits
// of the other a-rows are unspecified, and are 0 below DENSE_SURVIVORS
// survivors. Every a-row is tested from DENSE_SURVIVORS survivors up.
__device__ __forceinline__ void test_rows(const float4* al, const float4* ah,
                                          uint32_t surv, const Lanes& t,
                                          uint32_t (&word)[LPT]) {
#pragma unroll
  for (int i = 0; i < LPT; ++i) word[i] = 0u;
  if (__popc(surv) >= DENSE_SURVIVORS) {
    // Every a-row, bit 31 first: each result shifts in at bit 0.
#pragma unroll 8
    for (int r = 31; r >= 0; --r) {
      const float4 a = al[r], c = ah[r];
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        word[i] = __funnelshift_l(overlap(a, c, t.lo, t.hi, i), word[i], 1);
    }
  } else {
    for (; surv; surv &= surv - 1) {
      const int r = __ffs(surv) - 1;
      const float4 a = al[r], c = ah[r];
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        word[i] |= (overlap(a, c, t.lo, t.hi, i) & 0x80000000u) >> (31 - r);
    }
  }
}

// Sum of ``hits`` over the block's LANE threads, added to ``total`` by
// thread 0 with one integer atomic, so the total is deterministic.
__device__ __forceinline__ void block_add(int hits,
                                          unsigned long long* total) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, d);
  __shared__ int warp_hits[LANE / 32];
  const int l = threadIdx.x;
  if ((l & 31) == 0) warp_hits[l >> 5] = hits;
  __syncthreads();
  if (l == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < LANE / 32; ++w) sum += warp_hits[w];
    if (sum) atomicAdd(total, static_cast<unsigned long long>(sum));
  }
}

// The count kernels' block (whole block): chunk k of bucket b against
// its windows on offsets first_off .. NOFF-1, the set tile entries added
// to ``total``, with j > i on offset 0 and, with DMIN, j > i + dmin on
// every offset. The tables are flat, (b * mc + k) * NOFF + off. A
// window's lanes are one index range, [w, w + min(wc, rpw*128)) for
// rolled rows and [w, min(w + wc, (w/128 + rpw)*128)) for aligned ones,
// walked in 64-lane segments from floor(w/64)*64, so that each segment
// lies in one stream row; lanes of a segment outside the range stay out
// of the union and the count. The block's warps take the (offset,
// segment) units of its windows in turn. A dead chunk leaves at once,
// the whole block together.
template <int NOFF, bool ROLLED, bool DMIN>
__device__ __forceinline__ void count_block(
    const float* __restrict__ s, const int* __restrict__ starts,
    const int* __restrict__ w0, const int* __restrict__ wcap, int mc,
    int rpw, int first_off, int dmin, int b, int k,
    unsigned long long* __restrict__ total) {
  const int a1 = starts[b + 1];
  const int g0 = starts[b] + k * CHUNK;
  if (g0 >= a1) return;
  const int alen = min(a1 - g0, CHUNK);

  __shared__ float4 slo[CHUNK], shi[CHUNK];
  __shared__ cull::Box half_union[2];
  __shared__ int win[NOFF][3];   // each window's range [js, je), segments
  if (threadIdx.x < CHUNK) {
    stage_chunk(s, g0, alen, slo, shi, half_union);
  } else if (threadIdx.x < CHUNK + NOFF) {
    const int off = threadIdx.x - CHUNK;
    const long long e = (static_cast<long long>(b) * mc + k) * NOFF + off;
    const int w = w0[e], wc = wcap[e];
    const int je = ROLLED ? w + min(wc, rpw * LANE)
                          : min(w + wc, (w / LANE + rpw) * LANE);
    win[off][0] = w;
    win[off][1] = je;
    win[off][2] = off >= first_off && je > w
                  ? (je + SEG - 1) / SEG - w / SEG : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  int units = 0;
#pragma unroll
  for (int off = 0; off < NOFF; ++off) units += win[off][2];
  int hits = 0;
  for (int unit = warp; unit < units; unit += LANE / 32) {
    int off = 0, seg = unit;
    while (seg >= win[off][2]) seg -= win[off][2], ++off;
    const int js = win[off][0], je = win[off][1];
    const int j0 = (js / SEG + seg) * SEG + lt * LPT;
    cull::Box wu;
    const Lanes t = load_lanes(s, j0, js, je, &wu);
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // both halves at once: more to issue
      const float4* al = slo + h * 32;
      const float4* ah = shi + h * 32;
      uint32_t word[LPT], keep[LPT];
      test_rows(al, ah,
                survivors(al, ah, half_union[h], wu, t, (off == 0) || DMIN,
                          j0 - g0 - 32 * h - (DMIN ? dmin : 0), keep),
                t, word);
#pragma unroll
      for (int i = 0; i < LPT; ++i) hits += __popc(word[i] & keep[i]);
    }
  }
  block_add(hits, total);
}

}  // namespace column
