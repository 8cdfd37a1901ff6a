// Column sweep kernels: pair count (rolled or aligned window rows) and
// packed pair masks (aligned rows).
//
// Replaces collision_tpu/kernels/sweep.py: _make_rolled_kernel (the
// column engine's count, reached through sweep_count_guarded(rolled=True)),
// _make_kernel (the same count at aligned rows, sweep_count's default) and
// _make_masks_kernel (the masks that fill.mask_fill decodes, reached
// through sweep_masks).
//
// What bounds it on the H100: box tests issued. Each live chunk is tested
// against 5 offsets x rpw rows x 64 a-rows x 128 lanes: at 1M uniform
// spheres (gxy=26, ~15.6k live chunks, rpw=2) at most ~1.3G tests, while
// the bytes read are the 32 MB stream plus window re-reads that stay in
// the 50 MB L2. So it is bound by instruction issue, not by HBM.
//
// What this simple design does about it: one 128-thread block per
// (column, chunk) with the tile test of tile_test.cuh; a lane outside its
// window loads nothing and tests nothing, so the mostly empty second row
// of a rolled window costs a branch, not 64 tests. rpw is a runtime loop
// bound. The TPU kernel's slab DMA ring, lane rolls, chunk-pair
// transposes and unrolling have no use here and are gone. The count adds
// one integer atomic per block, so the total is deterministic.
//
// Built without --use_fast_math: the test is a compare of floats that the
// plan computed, and must match the CPU bit for bit.

#include "tile_test.cuh"

namespace {

using tile::LANE;

constexpr int NOFF = 5;   // columns.COLUMN_OFFSETS

// Block x = column * mc + chunk: one grid dimension, so gxy^2 * mc is the
// only bound on the grid.
template <bool ROLLED>
__global__ void __launch_bounds__(LANE)
column_count_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                    const int* __restrict__ w0, const int* __restrict__ wcap,
                    int mc, int rpw, unsigned long long* __restrict__ total) {
  tile::count_chunk<NOFF, ROLLED>(s, starts, w0, wcap, mc, rpw,
                                  blockIdx.x / mc, blockIdx.x % mc, total);
}

// Block x = column * (ng * kg) + chunk slot.
__global__ void __launch_bounds__(LANE)
column_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                    const int* __restrict__ w0, const int* __restrict__ wcap,
                    int mc, int rpw, int kg, int ng,
                    uint32_t* __restrict__ out) {
  const int slots = ng * kg;
  tile::masks_chunk<NOFF, false>(s, starts, w0, wcap, mc, rpw, kg, ng,
                                 blockIdx.x / slots, blockIdx.x % slots, out);
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
  const long long blocks = static_cast<long long>(ncols) * ng * kg;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0 && rpw > 0)
    column_masks_kernel<<<static_cast<unsigned>(blocks), LANE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        s, starts, w0, wcap, mc, rpw, kg, ng, out);
  return static_cast<int>(cudaGetLastError());
}
