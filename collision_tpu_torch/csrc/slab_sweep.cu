// Slab sweep kernels: pair count and packed pair masks.
//
// Replaces collision_tpu/kernels/slab_sweep.py: _make_slab_kernel (count,
// reached through slab_count_dual) and _make_slab_masks_kernel (masks,
// reached through slab_sweep_masks), both at one window row.
//
// What bounds it on the H100: the strict six-compare box test. At 1M
// uniform spheres the plan holds ~15.6k live chunks, each tested against
// two windows of up to 128 lanes: at most ~256M box tests, while
// the bytes read are the 32 MB stream once plus window re-reads that stay
// in the 50 MB L2. So it is bound by instruction issue, not by HBM.
//
// What this simple design does about it: one 128-thread block per
// (slab, chunk); the chunk's 64 a-side boxes sit in shared memory, where
// every thread reads the same word at once (a broadcast, no bank
// conflicts); each thread holds one window lane's box in registers and
// walks the a-rows. The TPU kernel's DMA ring, quad chunk pairing, lane
// rolls and [aw*64, 6] transpose have no use here and are gone. Lanes
// past the window are not read at all. The count reduces each block in
// registers and adds one integer atomic, so the total is deterministic.
//
// Built without --use_fast_math: the test is a compare of floats that the
// plan computed, and must match the CPU bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(LANE)
slab_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, unsigned long long* __restrict__ total) {
  const int k = blockIdx.x, x = blockIdx.y;
  const int a1 = starts[x + 1];
  const int g0 = starts[x] + k * CHUNK;
  if (g0 >= a1) return;   // dead chunk: the whole block leaves together
  const int alen = min(a1 - g0, CHUNK);

  __shared__ float sa[6][CHUNK];
  load_chunk(s, g0, alen, sa);
  __syncthreads();

  const int l = threadIdx.x;
  int hits = 0;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int e = (x * mc + k) * 2 + dx;
    if (l < min(wcap[e], LANE)) {
      const int j = w0[e] + l;
      const Box b = load_box(s, j);
      hits += __popc(tile_bits(sa, 0, min(alen, 32), b, dx == 0, j, g0));
      if (alen > 32)
        hits += __popc(tile_bits(sa, 32, alen, b, dx == 0, j, g0));
    }
  }

  // Block sum: warp shuffles, then one atomic per block.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, d);
  __shared__ int warp_hits[LANE / 32];
  if ((l & 31) == 0) warp_hits[l >> 5] = hits;
  __syncthreads();
  if (l == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < LANE / 32; ++w) sum += warp_hits[w];
    if (sum) atomicAdd(total, static_cast<unsigned long long>(sum));
  }
}

__global__ void __launch_bounds__(LANE)
slab_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int kg, int ng, uint32_t* __restrict__ out) {
  const int kq = blockIdx.x, x = blockIdx.y;   // kq in [0, ng*kg)
  const int g = kq / kg, kk = kq % kg;
  // Rows (kk*2 + off)*2 + h of block x*ng + g.
  uint32_t* rows = out + ((static_cast<long long>(x) * ng + g) * kg + kk) * 4 * LANE;
  const int l = threadIdx.x;
  const int a1 = starts[x + 1];
  const int g0 = starts[x] + kq * CHUNK;
  const int alen = kq < mc ? max(0, min(a1 - g0, CHUNK)) : 0;
  if (alen == 0) {   // dead chunk: every slot is still written
#pragma unroll
    for (int row = 0; row < 4; ++row) rows[row * LANE + l] = 0u;
    return;
  }

  __shared__ float sa[6][CHUNK];
  load_chunk(s, g0, alen, sa);
  __syncthreads();

#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int e = (x * mc + kq) * 2 + dx;
    uint32_t lo = 0u, hi = 0u;
    if (l < min(wcap[e], LANE)) {
      const int j = w0[e] + l;
      const Box b = load_box(s, j);
      lo = tile_bits(sa, 0, min(alen, 32), b, dx == 0, j, g0);
      if (alen > 32) hi = tile_bits(sa, 32, alen, b, dx == 0, j, g0);
    }
    rows[(dx * 2 + 0) * LANE + l] = lo;
    rows[(dx * 2 + 1) * LANE + l] = hi;
  }
}

}  // namespace

extern "C" int slab_count_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, unsigned long long* total,
                                 void* stream) {
  if (gx > 0 && mc > 0)
    slab_count_kernel<<<dim3(mc, gx), LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        s, starts, w0, wcap, mc, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_masks_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, int kg, int ng, uint32_t* out,
                                 void* stream) {
  if (gx > 0 && mc > 0)
    slab_masks_kernel<<<dim3(ng * kg, gx), LANE, 0, static_cast<cudaStream_t>(stream)>>>(
        s, starts, w0, wcap, mc, kg, ng, out);
  return static_cast<int>(cudaGetLastError());
}
