// Pair emission from packed sweep masks.
//
// Replaces collision_tpu/kernels/pair_emit.py: _make_emit_kernel (reached
// through emit_pairs, from fill._mask_fill_emit_pallas above
// BIG_FILL_THRESHOLD pairs).
//
// Mask row (nb, 2*sl + h), flat row = nb*2*KGT + 2*sl + h, holds 128 uint32
// words; bit b of lane l is the sorted pair (cb[g] + h*32 + b, wstart[g] +
// l) with g = row / 2 = nb*KGT + sl. The pairs leave in ascending (row,
// lane, bit) order, mapped to original ids through `ids`, the first
// `capacity` of them.
//
// What bounds it on the H100: bytes. Every mask word is read once and every
// pair writes two 4-byte ids; on the dense reference scene (107.65M pairs
// from 216.76M words) that is 0.87 GB + 0.86 GB, 0.52 ms at 3.35 TB/s. The
// id reads hit L2 (the sorted id array is 1.4 MB there).
//
// What this simple design does about it: one 128-thread block per mask row
// (a grid-stride loop past 2^20 rows). The row's first output slot comes
// from `bases`, the exclusive scan of the row popcounts that the wrapper
// queues on the stream (torch.cumsum, no host sync). Thread l popcounts its
// word, a block-wide exclusive scan gives its rank inside the row, and the
// thread writes its set bits in ascending order at base + rank + k while
// that slot is below `capacity`. The TPU kernel's staging ring, its
// register-carried partial row, the roll-merged id reads from VMEM and its
// sequential SMEM cursor exist because a Pallas TPU grid runs in order; they
// have no use here and are gone. The stores are scattered (each thread owns
// its own run of slots), which a later version can coalesce through shared
// memory.
//
// Slots are int64: on the dense scene they reach 1.1e8, and a row index
// times 128 passes 2^31 above 16.7M rows. Sorted indices are clamped to
// [0, nsort) before the id reads, as the plain version's gathers are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int LANE = 128;
constexpr long long MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ int id_at(const int* __restrict__ ids,
                                     long long nsort, long long k) {
  return ids[k < 0 ? 0 : (k >= nsort ? nsort - 1 : k)];
}

__global__ void __launch_bounds__(LANE)
pair_emit_kernel(const uint32_t* __restrict__ mask,
                 const long long* __restrict__ wstart,
                 const long long* __restrict__ cb, const int* __restrict__ ids,
                 long long nsort, const long long* __restrict__ bases,
                 long long rows, long long capacity, int* __restrict__ ida,
                 int* __restrict__ idb) {
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = bases[row];   // the same in every thread
    if (base >= capacity) continue;
    uint32_t bits = mask[row * LANE + threadIdx.x];
    int row_pairs;
    const int rank = scan::block_exclusive_scan(__popc(bits), &row_pairs);
    if (!bits) continue;
    const long long g = row >> 1;
    const long long a0 = cb[g] + (row & 1) * 32;
    const int id_b = id_at(ids, nsort, wstart[g] + threadIdx.x);
    for (long long slot = base + rank; bits && slot < capacity;
         bits &= bits - 1, ++slot) {
      ida[slot] = id_at(ids, nsort, a0 + __ffs(bits) - 1);
      idb[slot] = id_b;
    }
  }
}

}  // namespace

// The first `capacity` pairs of `rows` mask rows, row r's at bases[r]
// onwards; slots past the last pair are not written.
extern "C" int pair_emit_launch(const uint32_t* mask, const long long* wstart,
                                const long long* cb, const int* ids,
                                long long nsort, const long long* bases,
                                long long rows, long long capacity, int* ida,
                                int* idb, void* stream) {
  if (rows > 0 && capacity > 0 && nsort > 0) {
    const long long blocks = rows < MAX_BLOCKS ? rows : MAX_BLOCKS;
    pair_emit_kernel<<<static_cast<unsigned>(blocks), LANE, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        mask, wstart, cb, ids, nsort, bases, rows, capacity, ida, idb);
  }
  return static_cast<int>(cudaGetLastError());
}
