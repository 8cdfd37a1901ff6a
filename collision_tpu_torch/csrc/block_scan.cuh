// Block-wide exclusive scan of one int per thread, shared by the
// compaction (compact.cu), the big-sphere pass (bigpass.cu) and the pair
// emission (pair_emit.cu).
#pragma once

#include <cuda_runtime.h>

namespace scan {

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024); *total receives the block sum. Every
// thread calls it; it ends with a barrier, so calls may follow each other.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? warp_sums[lane] : 0;
    const int winc = warp_inclusive_scan(w);
    warp_sums[lane] = winc - w;
    if (lane == 31) warp_sums[32] = winc;
  }
  __syncthreads();
  const int out = warp_sums[warp] + inc - v;
  *total = warp_sums[32];
  __syncthreads();   // warp_sums is reused by the next call
  return out;
}

}  // namespace scan
