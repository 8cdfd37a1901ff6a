// Slab sweep kernels: pair count, packed pair masks and the diagonal count.
//
// Replaces collision_tpu/kernels/slab_sweep.py: _make_slab_kernel (count,
// reached through slab_count_dual, and through slab_count_diag's cross-only
// pass), _make_slab_masks_kernel (masks, reached through slab_sweep_masks),
// at rpw rolled window rows: one for the uniform slab engine, two for the
// hetero engine's slab pass; and _make_diag_kernel (reached through
// diag_count and slab_count_diag).
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
// Built without --use_fast_math: the test is a compare of floats that the
// plan computed, and must match the CPU bit for bit.

#include "tile_test.cuh"

namespace {

using tile::LANE;

// The slab engine's two offsets (self slab with j > i, slab x+1) at rpw
// rolled rows per window, from offset first_off on, with j > i + dmin on
// every offset when DMIN. RPW > 0 fixes the row count at compile time (the
// uniform engine's one row, whose loop then folds away); RPW = 0 reads it
// from rpw.
template <int RPW, bool DMIN>
__global__ void __launch_bounds__(LANE)
slab_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int first_off, int dmin,
                  unsigned long long* __restrict__ total) {
  tile::count_chunk<2, true, DMIN>(s, starts, w0, wcap, mc, RPW ? RPW : rpw,
                                   first_off, dmin, blockIdx.y, blockIdx.x,
                                   total);
}

template <int RPW>
__global__ void __launch_bounds__(LANE)
slab_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int kg, int ng, uint32_t* __restrict__ out) {
  tile::masks_chunk<2, true>(s, starts, w0, wcap, mc, RPW ? RPW : rpw, kg, ng,
                             blockIdx.y, blockIdx.x, out);
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
    sb[idx] = tile::stream_comp(s, p0 + 1 + idx % w, idx / w);

  const long long p = p0 + t;
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = tile::stream_comp(s, p, c);
    hi[c] = tile::stream_comp(s, p, c + 3);
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
  int flag = (tile::stream_comp(s, q, 7) == tile::stream_comp(s, p, 7)) &
             (tile::stream_comp(s, q, 2) < zhi_thr);

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
  if (gx > 0 && mc > 0 && rpw > 0) {
    const dim3 grid(mc, gx);
    auto st = static_cast<cudaStream_t>(stream);
    auto kernel = rpw == 1 ? (dmin > 0 ? slab_count_kernel<1, true>
                                       : slab_count_kernel<1, false>)
                           : (dmin > 0 ? slab_count_kernel<0, true>
                                       : slab_count_kernel<0, false>);
    kernel<<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw, first_off,
                                  dmin, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_masks_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, int rpw, int kg, int ng, uint32_t* out,
                                 void* stream) {
  if (gx > 0 && mc > 0 && rpw > 0) {
    const dim3 grid(ng * kg, gx);
    auto st = static_cast<cudaStream_t>(stream);
    if (rpw == 1)
      slab_masks_kernel<1><<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw,
                                                  kg, ng, out);
    else
      slab_masks_kernel<0><<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw,
                                                  kg, ng, out);
  }
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
