// The sorted stream's layout, shared by the sweep kernels (slab_sweep.cu,
// sweep.cu through column_tile.cuh) and the big pass (bigpass.cu).
//
// The stream is [Rp, 8, 128] float32: sorted sphere p is lane p % 128 of
// row p / 128, with channels xlo ylo zlo xhi yhi zhi, the id's bits, and
// the bucket key. A sweep kernel's block takes one 64-sphere a-chunk of a
// bucket (a slab or a column) with 128 threads, one a window lane of a
// 128-lane row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stream {

constexpr int CHUNK = 64;
constexpr int LANE = 128;   // threads per block = lanes per stream row

// Component c of sorted sphere p.
__device__ __forceinline__ float comp(const float* __restrict__ s,
                                      long long p, int c) {
  return s[(p / LANE) * (8 * LANE) + c * LANE + (p % LANE)];
}

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ s, int j) {
  Box b;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = comp(s, j, c);
    b.hi[c] = comp(s, j, c + 3);
  }
  return b;
}

}  // namespace stream
