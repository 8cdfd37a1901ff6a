// Slab sweep kernels: pair count and packed pair masks.
//
// Replaces collision_tpu/kernels/slab_sweep.py: _make_slab_kernel (count,
// reached through slab_count_dual) and _make_slab_masks_kernel (masks,
// reached through slab_sweep_masks), at rpw rolled window rows: one for
// the uniform slab engine, two for the hetero engine's slab pass.
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

#include "tile_test.cuh"

namespace {

using tile::LANE;

// The slab engine's two offsets (self slab with j > i, slab x+1) at rpw
// rolled rows per window. RPW > 0 fixes the row count at compile time (the
// uniform engine's one row, whose loop then folds away); RPW = 0 reads it
// from rpw.
template <int RPW>
__global__ void __launch_bounds__(LANE)
slab_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, unsigned long long* __restrict__ total) {
  tile::count_chunk<2, true>(s, starts, w0, wcap, mc, RPW ? RPW : rpw,
                             blockIdx.y, blockIdx.x, total);
}

template <int RPW>
__global__ void __launch_bounds__(LANE)
slab_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int kg, int ng, uint32_t* __restrict__ out) {
  tile::masks_chunk<2, true>(s, starts, w0, wcap, mc, RPW ? RPW : rpw, kg, ng,
                             blockIdx.y, blockIdx.x, out);
}

}  // namespace

extern "C" int slab_count_launch(const float* s, const int* starts,
                                 const int* w0, const int* wcap, int gx,
                                 int mc, int rpw, unsigned long long* total,
                                 void* stream) {
  if (gx > 0 && mc > 0 && rpw > 0) {
    const dim3 grid(mc, gx);
    auto st = static_cast<cudaStream_t>(stream);
    if (rpw == 1)
      slab_count_kernel<1><<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw, total);
    else
      slab_count_kernel<0><<<grid, LANE, 0, st>>>(s, starts, w0, wcap, mc, rpw, total);
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
