// Stream compaction: ascending indices of the set elements of a mask.
//
// Replaces collision_tpu/kernels/compact.py: _compact_kernel (reached
// through compact_mask, from slabs.residual_pairs, hetero._bb_extract and
// emit.grid_fill).
//
// What bounds it on the H100: reading the mask, one byte per element (1 MB
// on the slab fill's residual mask: 0.3 us at 3.35 TB/s), and writing
// `capacity` + 1 int64 slots. At these sizes the launch and the host's
// enqueue cost more than either.
//
// What this design does about it: one launch, one pass (Merrill & Garland's
// decoupled look-back). Each block takes a 4096-element tile, by ticket, not
// by blockIdx.x: a block only ever waits on tiles whose tickets were taken
// before its own, so by blocks that are running, and the look-back cannot
// deadlock. A tile reads 16 bytes a thread, counts its set bytes, scans the
// counts inside the block and stages the set elements' offsets in shared
// memory in ascending order. It publishes its aggregate in its status word,
// and warp 0 looks back 32 predecessors at a time, summing aggregates until
// it meets an inclusive prefix; the tile then publishes its own inclusive
// prefix and writes its indices at their slots below `capacity`, coalesced.
// The last tile writes the true total into slot `capacity`. Blocks with
// tickets past the last tile wait for the total and fill the slots from it
// up to `capacity` with 0xFFFFFFFF. The TPU kernel's per-hit min-reduce
// loop has no use here and is gone.
//
// The state that outlives a call is the caller's, zeroed once: a ticket
// counter, a count of the blocks done, the epoch, and one status word per
// tile. A status word is (epoch: 30 bits, flag: 2, value: 32), so words of
// earlier calls read as not yet published. The last block to finish resets
// the ticket and the count and moves the epoch on; when the epoch wraps it
// zeroes the status words. So a call needs no memset and takes no per-call
// count from the host. It holds in stream order only: two calls on the
// same state must not run at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

using scan::block_exclusive_scan;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;

constexpr unsigned long long FLAG_AGGREGATE = 1, FLAG_PREFIX = 2;

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, unsigned value) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) | value;
}

// The flag of a status word of this call, 0 for an earlier call's word.
__device__ __forceinline__ unsigned status_flag(unsigned long long w,
                                                unsigned epoch) {
  return (w >> 34) == epoch ? static_cast<unsigned>(w >> 32) & 3u : 0u;
}

// Bit i set when byte i of the 16 is not zero.
__device__ __forceinline__ unsigned set_bytes(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // One bit per byte (bits 0, 8, 16, 24), gathered into bits 24-27.
    const unsigned b = __vcmpne4(w[k], 0u) & 0x01010101u;
    m |= ((b * 0x01020408u) >> 24) << (4 * k);
  }
  return m;
}

// Warp 0: the tile's exclusive prefix, by look-back over its predecessors.
__device__ __forceinline__ unsigned look_back(unsigned long long* status,
                                              long long tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned exclusive = 0;
  for (long long j = tile - 1 - lane;; j -= 32) {
    unsigned long long w;
    unsigned flag;
    do {
      // Past the first tile: an inclusive prefix of 0.
      w = j >= 0 ? load_relaxed(status + j) : status_word(epoch, FLAG_PREFIX, 0);
      flag = status_flag(w, epoch);
    } while (__any_sync(FULL, flag == 0));
    const unsigned prefixes = __ballot_sync(FULL, flag == FLAG_PREFIX);
    // Sum the nearest predecessors down to the first inclusive prefix.
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    exclusive += __reduce_add_sync(FULL, lane <= stop ? static_cast<unsigned>(w) : 0u);
    if (prefixes) return exclusive;
  }
}

// The state's words before the status words.
enum { TICKET, DONE, EPOCH, STATUS };

// Counts the block out; the last block of the call resets the state for
// the next one. Every block calls it after its last write.
__device__ __forceinline__ void finish(unsigned long long* state,
                                       long long blocks, long long tiles,
                                       unsigned epochs) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(state + DONE, 1ull) ==
           static_cast<unsigned long long>(blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  // Every block has taken its ticket and read the epoch.
  const unsigned long long next = state[EPOCH] + 1 >= epochs ? 0 : state[EPOCH] + 1;
  if (next == 0)
    for (long long i = threadIdx.x; i < tiles; i += THREADS) state[STATUS + i] = 0;
  if (threadIdx.x == 0) {
    state[TICKET] = 0;
    state[DONE] = 0;
    state[EPOCH] = next;
  }
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const uint8_t* __restrict__ mask, long long n, long long nblk,
               int nfill, long long capacity, long long* __restrict__ out,
               unsigned long long* state, long long tiles, unsigned epochs) {
  __shared__ uint16_t offsets[TILE];
  __shared__ long long tile_s;
  __shared__ unsigned epoch_s, base_s;
  unsigned long long* status = state + STATUS;
  const int t = threadIdx.x;
  if (t == 0) {
    tile_s = static_cast<long long>(atomicAdd(state + TICKET, 1ull));
    epoch_s = static_cast<unsigned>(state[EPOCH]) + 1;
  }
  __syncthreads();
  const long long tile = tile_s;
  const unsigned epoch = epoch_s;

  if (tile >= nblk) {
    // A filling block: the slots from the total up to `capacity`.
    if (t == 0) {
      unsigned long long w;
      do {
        w = load_relaxed(status + nblk - 1);
      } while (status_flag(w, epoch) != FLAG_PREFIX);
      base_s = static_cast<unsigned>(w);
    }
    __syncthreads();
    const long long stride = static_cast<long long>(nfill) * THREADS;
    for (long long q = base_s + (tile - nblk) * THREADS + t; q < capacity;
         q += stride)
      out[q] = 0xFFFFFFFFll;
    finish(state, nblk + nfill, tiles, epochs);
    return;
  }

  // Which of this thread's 16 elements are set.
  const long long p0 = tile * TILE + t * ITEMS;
  unsigned bits = 0;
  if (p0 + ITEMS <= n && (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
    bits = set_bytes(*reinterpret_cast<const uint4*>(mask + p0));
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) bits |= (p0 + i < n && mask[p0 + i]) << i;
  }
  int aggregate;
  int rank = block_exclusive_scan(__popc(bits), &aggregate);
  for (; bits; bits &= bits - 1)
    offsets[rank++] = static_cast<uint16_t>(t * ITEMS + __ffs(bits) - 1);

  if (t < 32) {
    unsigned exclusive = 0;
    if (tile == 0) {
      if (t == 0)
        store_relaxed(status, status_word(epoch, FLAG_PREFIX, aggregate));
    } else {
      if (t == 0)
        store_relaxed(status + tile,
                      status_word(epoch, FLAG_AGGREGATE, aggregate));
      exclusive = look_back(status, tile, epoch);
      if (t == 0)
        store_relaxed(status + tile,
                      status_word(epoch, FLAG_PREFIX, exclusive + aggregate));
    }
    if (t == 0) {
      base_s = exclusive;
      if (tile == nblk - 1) out[capacity] = exclusive + aggregate;
    }
  }
  __syncthreads();
  const long long base = base_s;
  for (int i = t; i < aggregate && base + i < capacity; i += THREADS)
    out[base + i] = tile * TILE + offsets[i];
  finish(state, nblk + nfill, tiles, epochs);
}

}  // namespace

// Mask elements per tile: the caller sizes the status words (one a tile).
extern "C" int compact_tile() { return TILE; }

// out[capacity + 1]: the ascending indices of the set bytes of mask[n], the
// first `capacity` of them, 0xFFFFFFFF in the slots past the total, and the
// total in out[capacity]; `nblk` tiles (>= n / tile, >= 1) and `nfill`
// filling blocks (>= 1 when capacity > 0). `state` holds 3 + `tiles`
// words (tiles >= nblk), zeroed before its first call; its epochs run
// 1 .. `epochs` (at most 2^30 - 1).
extern "C" int compact_launch(const uint8_t* mask, long long n, long long nblk,
                              int nfill, long long capacity, long long* out,
                              unsigned long long* state, long long tiles,
                              unsigned epochs, void* stream) {
  if (n < 0 || nblk < 1 || nblk * TILE < n || tiles < nblk || nfill < 0 ||
      (capacity > 0 && nfill < 1) || capacity < 0 || epochs < 1 ||
      epochs >= (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  compact_kernel<<<static_cast<unsigned>(nblk + nfill), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      mask, n, nblk, nfill, capacity, out, state, tiles, epochs);
  return static_cast<int>(cudaGetLastError());
}
