// Stream compaction: ascending indices of the set elements of a mask.
//
// Replaces collision_tpu/kernels/compact.py: _compact_kernel (reached
// through compact_mask, from slabs.residual_pairs).
//
// What bounds it on the H100: reading the mask, one byte per element
// (~1M elements on the fill path, 1 MB: microseconds at 3.35 TB/s), plus
// three launches. Writes are O(capacity).
//
// What this simple design does about it: a two-pass block-scan compaction
// with no host sync. Pass 1 counts the set elements of each 4096-element
// tile (256 threads x 16 consecutive elements); a one-block kernel scans
// the tile counts into tile bases and the true total; pass 2 re-reads each
// tile, scans the threads' counts inside the block and writes each set
// element's index to its slot below `capacity`, then fills the slots from
// the total up to `capacity` with 0xFFFFFFFF. The order is ascending, as
// the TPU kernel's sequential cursor gave, and deterministic. The TPU
// kernel's per-hit min-reduce loop has no use here and is gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using scan::block_exclusive_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ int thread_count(const uint8_t* __restrict__ mask,
                                            long long n, long long p0) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) c += (p0 + i < n) && mask[p0 + i];
  return c;
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ counts) {
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int total;
  block_exclusive_scan(thread_count(mask, n, p0), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// One block: tile counts -> exclusive tile bases, in place; the sum.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ counts, int nblk, int* __restrict__ total) {
  int carry = 0;
  for (int base = 0; base < nblk; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < nblk ? counts[i] : 0;
    int sum;
    const int ex = block_exclusive_scan(v, &sum);
    if (i < nblk) counts[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(THREADS)
write_kernel(const uint8_t* __restrict__ mask, long long n,
             const int* __restrict__ bases, const int* __restrict__ total,
             int capacity, int* __restrict__ out) {
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  int unused;
  int slot = bases[blockIdx.x] +
             block_exclusive_scan(thread_count(mask, n, p0), &unused);
  for (int i = 0; i < ITEMS && slot < capacity; ++i) {
    if (p0 + i < n && mask[p0 + i]) out[slot++] = static_cast<int>(p0 + i);
  }
  // Slots past the true total hold the sentinel.
  for (long long q = *total + static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       q < capacity; q += static_cast<long long>(gridDim.x) * THREADS)
    out[q] = -1;   // 0xFFFFFFFF
}

}  // namespace

// Mask elements per block: the caller sizes `counts` (nblk >= n / tile).
extern "C" int compact_tile() { return TILE; }

extern "C" int compact_launch(const uint8_t* mask, long long n, int capacity,
                              int* counts, int* total, int* out, int nblk,
                              void* stream) {
  if (static_cast<long long>(nblk) * TILE < n || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<nblk, THREADS, 0, s>>>(mask, n, counts);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(counts, nblk, total);
  write_kernel<<<nblk, THREADS, 0, s>>>(mask, n, counts, total, capacity, out);
  return static_cast<int>(cudaGetLastError());
}
