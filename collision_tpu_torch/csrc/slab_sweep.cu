// Slab sweep kernels: pair count, packed pair masks and the diagonal count.
//
// Replaces collision_tpu/kernels/slab_sweep.py: _make_slab_kernel (count,
// reached through slab_count_dual, and through slab_count_diag's cross-only
// pass), _make_slab_masks_kernel (masks, reached through slab_sweep_masks),
// at rpw rolled window rows: one for the uniform slab engine, two for the
// hetero engine's slab pass; and _make_diag_kernel (reached through
// diag_count and slab_count_diag).
//
// What bounds them on the H100. At 1M uniform spheres the plan holds
// ~15.6k live chunks, each against two rolled windows of up to 128
// lanes: 166,196,256 box tests in the windows, of which an exact cull
// of each 32-row mask word leaves 45,111,184 (0.004 ms of float adds).
// Their bytes are the stream's six box channels and the tables, read
// once (0.0073 ms at 3.35 TB/s), with window re-reads that stay in the
// 50 MB L2, and for the masks the words written (0.0177 ms in all).
// Neither holds them, as with the column kernels (sweep.cu): each block
// is a chain of latencies, staging, lane loads, unions, ballots.
//
// What the design does about it: the column kernels' tile test
// (column_tile.cuh). One 128-thread block per (chunk, slab) stages the
// chunk's 64 a-rows and the union box of each 32-row half in shared
// memory; a warp takes 64 window lanes, two a thread; a half is tested
// only if a lane meets its union, and then only its a-rows that meet
// the lanes' union, each test six float differences' sign bits. The
// count is the column count's block (count_block) on the slab's two
// offsets, self slab (j > i) and slab x+1, from offset first_off on;
// with DMIN (slab_count_diag's cross-only pass) j > i + dmin on every
// offset, one shift of the self mask. The masks write each window row's
// words at rolled lanes: a warp takes 64 words of a row, word l at
// sorted position w + r*128 + l, each lane loaded on its own (a lane
// pair may span two stream rows), and a thread stores its two words of
// each half with one 8-byte store. On an H100 8-byte loads where w is
// even were no faster, and the count's walk of stream-aligned segments,
// storing each word on its own, 13-17% slower (masks_variants.py). The
// TPU kernel's DMA ring, quad chunk pairing, lane rolls and [aw*64, 6]
// transpose have no use here and are gone.
//
// The diagonal count tests every sorted position i against i+1 .. i+d_max,
// and runs the missed-pair detector at i+d_max+1. At 1M spheres and the
// default d_max of 48 that is ~48M box tests over a 33 MB stream: a few
// microseconds of compares against ~10 us of bytes, so it is bound by the
// stream's bytes. One thread per position holds its box in registers; the
// block stages the boxes of its 256 positions and the d_max after them in
// shared memory once, read coalesced, and each thread walks its diagonal
// there (consecutive threads read consecutive words: no bank conflicts).
// The TPU kernel's block pairing (a 32-row block beside its successor),
// lane rolls and static unroll over the diagonals have no use here and are
// gone; its skipped last block is kept as the domain's end. Totals reduce
// per block and add one integer atomic each, so both are deterministic.
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

constexpr int NOFF = 2;   // self slab, slab x+1

// Count block (k, x): chunk k of slab x, rolled rows (column::count_block).
template <bool DMIN>
__global__ void __launch_bounds__(LANE)
slab_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int first_off, int dmin,
                  unsigned long long* __restrict__ total) {
  column::count_block<NOFF, true, DMIN>(s, starts, w0, wcap, mc, rpw,
                                        first_off, dmin, blockIdx.y,
                                        blockIdx.x, total);
}

// Masks block (kq, x): chunk slot kq of slab x (kq in [0, ng*kg)) writes
// its NOFF*rpw*2 rows of 128 words, row (off*rpw + r)*2 + h of chunk kk =
// kq % kg in block x*ng + kq / kg, word l = rolled window lane r*128 + l,
// bit t = a-row h*32 + t. Every word is written: slots past mc and dead
// chunks write zeros, 16 bytes a store, and a segment of words past the
// window writes zeros and loads nothing. The warps take the (offset,
// row, segment) units.
__global__ void __launch_bounds__(LANE)
slab_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int kg, int ng, uint32_t* __restrict__ out) {
  const int b = blockIdx.y, kq = blockIdx.x;
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
    const int seg0 = r * LANE + (unit % ROW_SEGS) * SEG;   // rolled lane
    const int l0 = seg0 % LANE + lt * LPT;                 // first word
    uint2* row = reinterpret_cast<uint2*>(rows + (off * rpw + r) * 2 * LANE
                                          + l0);
    if (seg0 >= wc) {   // the warp's segment, uniform: past the window
      row[0] = make_uint2(0u, 0u);
      row[LANE / LPT] = make_uint2(0u, 0u);
      continue;
    }
    const int j0 = w + seg0 + lt * LPT;
    cull::Box wu;
    const column::Lanes t = column::load_rolled_lanes(s, j0, w, w + wc, &wu);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const float4* al = slo + h * 32;
      const float4* ah = shi + h * 32;
      const cull::Box hu = half_union[h];   // a register copy, as sweep.cu
      uint32_t word[LPT], keep[LPT];
      column::test_rows(al, ah,
                        column::survivors(al, ah, hu, wu, t, off == 0,
                                          j0 - g0 - 32 * h, keep),
                        t, word);
      row[h * LANE / LPT] = make_uint2(word[0] & keep[0], word[1] & keep[1]);
    }
  }
}

constexpr int DIAG_THREADS = 256;

// Block x takes positions p0 = x * DIAG_THREADS .. p0 + DIAG_THREADS - 1.
// Partner p + d (1 <= d <= d_max) of thread t sits at column t + d - 1 of
// the staged [6][DIAG_THREADS + d_max] boxes (positions p0 + 1 on).
__global__ void __launch_bounds__(DIAG_THREADS)
diag_count_kernel(const float* __restrict__ s, const float* __restrict__ thr,
                  int d_max, unsigned long long* __restrict__ total,
                  unsigned long long* __restrict__ flagged) {
  extern __shared__ float sb[];
  const int w = DIAG_THREADS + d_max;
  const int t = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * DIAG_THREADS;
  for (int idx = t; idx < 6 * w; idx += DIAG_THREADS)
    sb[idx] = stream::comp(s, p0 + 1 + idx % w, idx / w);

  const long long p = p0 + t;
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = stream::comp(s, p, c);
    hi[c] = stream::comp(s, p, c + 3);
  }
  __syncthreads();

  int hits = 0;
  for (int col = t; col < t + d_max; ++col)
    hits += (hi[0] > sb[col]) & (lo[0] < sb[3 * w + col]) &
            (hi[1] > sb[w + col]) & (lo[1] < sb[4 * w + col]) &
            (hi[2] > sb[2 * w + col]) & (lo[2] < sb[5 * w + col]);
  // Missed-pair detector at distance d_max + 1: same slab (channel 7, a
  // float compare as in the TPU kernel) and z within thr. Pads are +inf
  // in every channel, so "inf < inf + thr" never flags them.
  const long long q = p + d_max + 1;
  const float zhi_thr = hi[2] + thr[0];
  int flag = (stream::comp(s, q, 7) == stream::comp(s, p, 7)) &
             (stream::comp(s, q, 2) < zhi_thr);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, o);
    flag += __shfl_down_sync(0xffffffffu, flag, o);
  }
  __shared__ int warp_sums[2][DIAG_THREADS / 32];
  if ((t & 31) == 0) {
    warp_sums[0][t >> 5] = hits;
    warp_sums[1][t >> 5] = flag;
  }
  __syncthreads();
  if (t == 0) {
    int h = 0, f = 0;
#pragma unroll
    for (int i = 0; i < DIAG_THREADS / 32; ++i) {
      h += warp_sums[0][i];
      f += warp_sums[1][i];
    }
    if (h) atomicAdd(total, static_cast<unsigned long long>(h));
    if (f) atomicAdd(flagged, static_cast<unsigned long long>(f));
  }
}

}  // namespace

extern "C" int slab_count_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, int rpw, int first_off, int dmin,
                                 unsigned long long* total, void* stream) {
  if (first_off < 0 || first_off >= NOFF || dmin < 0 ||
      (reinterpret_cast<uintptr_t>(s) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gx > 0 && mc > 0 && rpw > 0) {
    const dim3 grid(mc, gx);
    auto st = static_cast<cudaStream_t>(stream);
    auto kernel = dmin > 0 ? slab_count_kernel<true> : slab_count_kernel<false>;
    kernel<<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw, first_off,
                                  dmin, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_masks_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, int rpw, int kg, int ng, uint32_t* out,
                                 void* stream) {
  // The vector loads and stores need 16-byte aligned stream and masks.
  if ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gx > 0 && mc > 0 && rpw > 0)
    slab_masks_kernel<<<dim3(ng * kg, gx), LANE, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        s, starts, w0, wcap, mc, rpw, kg, ng, out);
  return static_cast<int>(cudaGetLastError());
}

// ``positions``: the count's domain, (Rp - DIAG_B) * 128 sorted positions,
// a multiple of DIAG_THREADS; the stream holds at least positions +
// d_max + 1 of them. out[0] is the pair count, out[1] the detector's.
extern "C" int diag_count_launch(const float* s, const float* thr,
                                 long long positions, int d_max,
                                 unsigned long long* out, void* stream) {
  if (positions % DIAG_THREADS || d_max < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (positions > 0) {
    const size_t smem = sizeof(float) * 6 * (DIAG_THREADS + d_max);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          diag_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    diag_count_kernel<<<positions / DIAG_THREADS, DIAG_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        s, thr, d_max, out, out + 1);
  }
  return static_cast<int>(cudaGetLastError());
}
