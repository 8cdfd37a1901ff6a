// The tile test shared by the sweep kernels (slab_sweep.cu, sweep.cu).
//
// One 128-thread block takes one 64-sphere a-chunk of one bucket (a slab
// or a column) of the [Rp, 8, 128] sorted stream. The chunk's boxes sit
// in shared memory, where every thread reads the same word at once (a
// broadcast). Thread l holds the box of lane l of one window row in
// registers and walks the a-rows with the strict six-compare test. The
// window tables are flat, (bucket * mc + k) * NOFF + off.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int CHUNK = 64;
constexpr int LANE = 128;   // threads per block = window lanes per row

// Component c of sorted sphere p in the [Rp, 8, 128] stream.
__device__ __forceinline__ float stream_comp(const float* __restrict__ s,
                                             long long p, int c) {
  return s[(p / LANE) * (8 * LANE) + c * LANE + (p % LANE)];
}

// The chunk's a-side boxes, component-major, into shared memory.
__device__ __forceinline__ void load_chunk(const float* __restrict__ s,
                                           int g0, int alen,
                                           float (*sa)[CHUNK]) {
  for (int idx = threadIdx.x; idx < 6 * CHUNK; idx += blockDim.x) {
    const int c = idx / CHUNK, r = idx % CHUNK;
    sa[c][r] = r < alen ? stream_comp(s, g0 + r, c) : 0.0f;
  }
}

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ s, int j) {
  Box b;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = stream_comp(s, j, c);
    b.hi[c] = stream_comp(s, j, c + 3);
  }
  return b;
}

// Strict AABB overlap of a-row r with box b (collision.cl:164-166).
__device__ __forceinline__ bool overlaps(float (*sa)[CHUNK], int r,
                                         const Box& b) {
  return (sa[3][r] > b.lo[0]) & (sa[0][r] < b.hi[0]) &
         (sa[4][r] > b.lo[1]) & (sa[1][r] < b.hi[1]) &
         (sa[5][r] > b.lo[2]) & (sa[2][r] < b.hi[2]);
}

// Bits r in [r0, r1) of the tile column of window lane j: set iff a-row r
// overlaps j, and, for the self offset, j > i = g0 + r.
__device__ __forceinline__ uint32_t tile_bits(float (*sa)[CHUNK],
                                              int r0, int r1, const Box& b,
                                              bool self, int j, int g0) {
  uint32_t bits = 0;
  for (int r = r0; r < r1; ++r) {
    const bool hit = overlaps(sa, r, b) & (!self | (j > g0 + r));
    bits |= static_cast<uint32_t>(hit) << (r - r0);
  }
  return bits;
}

// Set bits of the whole tile column of lane j (a-rows [0, alen)).
__device__ __forceinline__ int tile_hits(float (*sa)[CHUNK], int alen,
                                         const Box& b, bool self, int j,
                                         int g0) {
  int hits = __popc(tile_bits(sa, 0, min(alen, 32), b, self, j, g0));
  if (alen > 32) hits += __popc(tile_bits(sa, 32, alen, b, self, j, g0));
  return hits;
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

// Sorted position j of lane l of window row r, and whether it lies in the
// window [w, w + wc). Rolled rows start at the window: j = w + r*128 + l.
// Aligned rows are stream rows: j = (w / 128 + r) * 128 + l, so up to 127
// lanes of the first and last rows fall outside the window; they are
// never read.
template <bool ROLLED>
__device__ __forceinline__ bool window_lane(int w, int wc, int r, int l,
                                            int* j) {
  if (ROLLED) {
    const int rel = r * LANE + l;
    *j = w + rel;
    return rel < wc;
  }
  *j = (w / LANE + r) * LANE + l;
  return (*j >= w) & (*j < w + wc);
}

// Count block: chunk k of bucket b against rpw rows of each of its NOFF
// windows (j > i on offset 0), added to ``total``. A dead chunk leaves at
// once, the whole block together.
template <int NOFF, bool ROLLED>
__device__ __forceinline__ void count_chunk(
    const float* __restrict__ s, const int* __restrict__ starts,
    const int* __restrict__ w0, const int* __restrict__ wcap, int mc,
    int rpw, int b, int k, unsigned long long* __restrict__ total) {
  const int a1 = starts[b + 1];
  const int g0 = starts[b] + k * CHUNK;
  if (g0 >= a1) return;
  const int alen = min(a1 - g0, CHUNK);

  __shared__ float sa[6][CHUNK];
  load_chunk(s, g0, alen, sa);
  __syncthreads();

  int hits = 0;
#pragma unroll
  for (int off = 0; off < NOFF; ++off) {
    const long long e = (static_cast<long long>(b) * mc + k) * NOFF + off;
    const int w = w0[e], wc = wcap[e];
    for (int r = 0; r < rpw; ++r) {
      int j;
      if (window_lane<ROLLED>(w, wc, r, threadIdx.x, &j))
        hits += tile_hits(sa, alen, load_box(s, j), off == 0, j, g0);
    }
  }
  block_add(hits, total);
}

// Masks block: chunk slot kq of bucket b (kq in [0, ng*kg)) writes its
// NOFF*rpw*2 rows of 128 words, row (off*rpw + r)*2 + h of chunk kk = kq %
// kg in block b*ng + kq / kg, bit t of a word = a-row h*32 + t. Every word
// is written: slots past mc and dead chunks write zeros.
template <int NOFF, bool ROLLED>
__device__ __forceinline__ void masks_chunk(
    const float* __restrict__ s, const int* __restrict__ starts,
    const int* __restrict__ w0, const int* __restrict__ wcap, int mc,
    int rpw, int kg, int ng, int b, int kq, uint32_t* __restrict__ out) {
  const int nrows = NOFF * rpw * 2;
  uint32_t* rows = out + ((static_cast<long long>(b) * ng + kq / kg) * kg
                          + kq % kg) * nrows * LANE;
  const int l = threadIdx.x;
  const int a1 = starts[b + 1];
  const int g0 = starts[b] + kq * CHUNK;
  const int alen = kq < mc ? max(0, min(a1 - g0, CHUNK)) : 0;
  if (alen == 0) {
    for (int row = 0; row < nrows; ++row) rows[row * LANE + l] = 0u;
    return;
  }

  __shared__ float sa[6][CHUNK];
  load_chunk(s, g0, alen, sa);
  __syncthreads();

#pragma unroll
  for (int off = 0; off < NOFF; ++off) {
    const long long e = (static_cast<long long>(b) * mc + kq) * NOFF + off;
    const int w = w0[e], wc = wcap[e];
    for (int r = 0; r < rpw; ++r) {
      uint32_t lo = 0u, hi = 0u;
      int j;
      if (window_lane<ROLLED>(w, wc, r, l, &j)) {
        const Box box = load_box(s, j);
        lo = tile_bits(sa, 0, min(alen, 32), box, off == 0, j, g0);
        if (alen > 32) hi = tile_bits(sa, 32, alen, box, off == 0, j, g0);
      }
      uint32_t* row = rows + (off * rpw + r) * 2 * LANE;
      row[l] = lo;
      row[LANE + l] = hi;
    }
  }
}

}  // namespace tile
