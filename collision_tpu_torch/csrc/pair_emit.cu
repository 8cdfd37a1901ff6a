// Pair emission from packed sweep masks, and the masks' row counts.
//
// Replaces collision_tpu/kernels/pair_emit.py: _make_emit_kernel (reached
// through emit_pairs, from fill._mask_fill_emit_pallas above
// BIG_FILL_THRESHOLD pairs), and the row popcount table that emit_pairs
// computes when the caller passes none.
//
// Mask row (nb, 2*sl + h), flat row = nb*2*KGT + 2*sl + h, holds 128 uint32
// words; bit b of lane l is the sorted pair (cb[g] + h*32 + b, wstart[g] +
// l) with g = row / 2 = nb*KGT + sl. The pairs leave in ascending (row,
// lane, bit) order, mapped to original ids through `ids`, the first
// `capacity` of them, into one int64 [capacity, 2] buffer of uint32 values:
// slot s is pairs[s] = (a, b), and the slots past the last pair hold
// (0xFFFFFFFF, 0xFFFFFFFF). The buffer is the collision result's own pair
// array, so no copy follows the kernel.
//
// What bounds them on the H100: bytes. row_popcount_kernel reads every mask
// word once and writes 8 bytes a row (0.87 GB on the dense reference scene:
// 0.26 ms at 3.35 TB/s). pair_emit_kernel reads the masks once more and
// writes one 16-byte (a, b) slot (on the dense scene 0.87 GB + 1.76 GB for
// 110M slots, 0.79 ms). The id reads hit L2 (the sorted ids are 2.4 MB).
//
// What this design does about it. The row counts: one warp a row, a 16-byte
// load a lane, __popc and a warp reduce. The emission: one 128-thread block
// a row at a time, in a grid-stride walk that fetches its next row's words
// and tables while it emits the current one. The row's first slot is the
// end of the previous row in `ends`, the inclusive scan of the row counts
// that the wrapper queues on the stream (torch.cumsum, no host sync). Thread
// l popcounts its word, a block-wide exclusive scan gives its rank inside
// the row, and the thread writes a 12-bit code (lane, bit) for each of its
// set bits at rank + k in shared memory, so the codes stand in slot order.
// The row's 32 a-ids and its lanes' b-ids go to shared memory too. Then the
// whole block writes the row's slot range [start, end), one 16-byte store a
// slot, thread l the slots start + l, start + l + 128, ..., decoding each
// code through the staged ids: a warp's stores are 512 contiguous bytes.
// Last, every block writes (0xFFFFFFFF, 0xFFFFFFFF) into its share of the
// slots from the total up to `capacity`. The stores are streaming
// (__stcs, evict first): nothing here reads the buffer back, and plain
// stores of the one interleaved buffer took 1.45 ms on the dense scene
// against 1.27 ms streaming (110M slots, H100 at 700 W). The TPU kernel's staging
// ring, its register-carried partial row, the roll-merged id reads from VMEM
// and its sequential SMEM cursor exist because a Pallas TPU grid runs in
// order; they have no use here and are gone.
//
// Slots are int64: on the dense scene they reach 1.1e8, and a row index
// times 128 passes 2^31 above 16.7M rows. Sorted indices are clamped to
// [0, nsort) before the id reads, as the plain version's gathers are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int LANE = 128;
constexpr int ROW_BITS = LANE * 32;
constexpr int COUNT_THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;
constexpr long long NO_PAIR = 0xFFFFFFFFll;

__global__ void __launch_bounds__(COUNT_THREADS)
row_popcount_kernel(const uint4* __restrict__ mask, long long rows,
                    long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (COUNT_THREADS / 32);
  for (long long row = (static_cast<long long>(blockIdx.x) * COUNT_THREADS +
                        threadIdx.x) >> 5;
       row < rows; row += warps) {
    const uint4 w = __ldg(mask + row * (LANE / 4) + lane);
    const unsigned c = __reduce_add_sync(
        0xffffffffu, __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w));
    if (lane == 0) counts[row] = c;
  }
}

__device__ __forceinline__ unsigned id_at(const long long* __restrict__ ids,
                                          long long nsort, long long k) {
  return static_cast<unsigned>(ids[k < 0 ? 0 : (k >= nsort ? nsort - 1 : k)]);
}

// What a block reads of a row before it emits it.
struct Row {
  long long start, end, a0, w0;
  uint32_t bits;
};

__device__ __forceinline__ Row fetch(const uint32_t* __restrict__ mask,
                                     const long long* __restrict__ wstart,
                                     const long long* __restrict__ cb,
                                     const long long* __restrict__ ends,
                                     long long row) {
  const long long g = row >> 1;
  return {row ? ends[row - 1] : 0, ends[row], cb[g] + (row & 1) * 32, wstart[g],
          mask[row * LANE + threadIdx.x]};
}

__global__ void __launch_bounds__(LANE)
pair_emit_kernel(const uint32_t* __restrict__ mask,
                 const long long* __restrict__ wstart,
                 const long long* __restrict__ cb,
                 const long long* __restrict__ ids, long long nsort,
                 const long long* __restrict__ ends, long long rows,
                 long long capacity, longlong2* __restrict__ pairs) {
  __shared__ uint16_t code[ROW_BITS];   // lane << 5 | bit, in slot order
  __shared__ unsigned id_a[32], id_b[LANE];
  const int t = threadIdx.x;
  Row next;
  if (blockIdx.x < rows) next = fetch(mask, wstart, cb, ends, blockIdx.x);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const Row cur = next;
    if (row + gridDim.x < rows)
      next = fetch(mask, wstart, cb, ends, row + gridDim.x);
    // This block's later rows start later still.
    if (cur.start >= capacity) break;
    if (cur.end == cur.start) continue;
    int unused;
    int rank = scan::block_exclusive_scan(__popc(cur.bits), &unused);
    if (t < 32) id_a[t] = id_at(ids, nsort, cur.a0 + t);
    if (cur.bits) id_b[t] = id_at(ids, nsort, cur.w0 + t);
    for (uint32_t b = cur.bits; b; b &= b - 1)
      code[rank++] = static_cast<uint16_t>(t << 5 | (__ffs(b) - 1));
    __syncthreads();
    const long long end = cur.end < capacity ? cur.end : capacity;
    for (long long s = cur.start + t; s < end; s += LANE) {
      const int c = code[s - cur.start];
      __stcs(pairs + s, make_longlong2(id_a[c & 31], id_b[c >> 5]));
    }
    __syncthreads();   // the next row's codes overwrite these
  }
  const long long total = rows > 0 ? ends[rows - 1] : 0;
  for (long long q = total + static_cast<long long>(blockIdx.x) * LANE + t;
       q < capacity; q += static_cast<long long>(gridDim.x) * LANE)
    __stcs(pairs + q, make_longlong2(NO_PAIR, NO_PAIR));
}

}  // namespace

// counts[r] = the set bits of the 128-word row r of `mask` (16-byte aligned).
extern "C" int row_popcount_launch(const uint32_t* mask, long long rows,
                                   long long* counts, void* stream) {
  if (reinterpret_cast<uintptr_t>(mask) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows > 0) {
    long long blocks = (rows + COUNT_THREADS / 32 - 1) / (COUNT_THREADS / 32);
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    row_popcount_kernel<<<static_cast<unsigned>(blocks), COUNT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint4*>(mask), rows, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first `capacity` pairs of `rows` mask rows, row r's in slots
// [ends[r - 1], ends[r]) (ends[-1] = 0), and 0xFFFFFFFF in the slots from
// ends[rows - 1] up to `capacity`, into the int64 [capacity, 2] buffer
// `pairs` (16-byte aligned).
extern "C" int pair_emit_launch(const uint32_t* mask, const long long* wstart,
                                const long long* cb, const long long* ids,
                                long long nsort, const long long* ends,
                                long long rows, long long capacity,
                                long long* pairs, void* stream) {
  if (reinterpret_cast<uintptr_t>(pairs) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (capacity > 0) {
    if (nsort <= 0) rows = 0;   // no ids: every slot is a sentinel
    const long long blocks = rows < 1 ? 1 : (rows < MAX_BLOCKS ? rows : MAX_BLOCKS);
    pair_emit_kernel<<<static_cast<unsigned>(blocks), LANE, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        mask, wstart, cb, ids, nsort, ends, rows, capacity,
        reinterpret_cast<longlong2*>(pairs));
  }
  return static_cast<int>(cudaGetLastError());
}
