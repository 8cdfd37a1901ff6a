// Union boxes and the exact cull shared by the grid count (grid.cu) and
// the big pass's count (bigpass.cu).
//
// The union box of a set of rows is the min of their lo and the max of
// their hi on each axis, over the live rows only (xlo below +inf): no
// arithmetic, so it holds the stored bounds themselves. A row that fails
// the strict test a.hi > u.lo && a.lo < u.hi on some axis against the
// union of a set fails it against every row of the set, so culling it
// drops only tests that would fail. Rows that are not live, and NaN
// bounds, fail every test whatever they meet: they stay out of the union
// (fminf / fmaxf skip NaN), which only tightens it.
#pragma once

#include <cuda_runtime.h>

namespace cull {

constexpr unsigned FULL = 0xffffffffu;

struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool live(float xlo) { return xlo < pos_inf(); }

// The union of no rows: every strict test against it fails.
__device__ __forceinline__ Box empty() {
  Box u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u.lo[c] = pos_inf();
    u.hi[c] = -pos_inf();
  }
  return u;
}

// Adds row r (any type with lo[3] and hi[3]) to u if it is live.
template <class R>
__device__ __forceinline__ void add(Box& u, const R& r) {
  if (!live(r.lo[0])) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u.lo[c] = fminf(u.lo[c], r.lo[c]);
    u.hi[c] = fmaxf(u.hi[c], r.hi[c]);
  }
}

// Folds v into u (both unions, never NaN).
__device__ __forceinline__ void merge(Box& u, const Box& v) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u.lo[c] = fminf(u.lo[c], v.lo[c]);
    u.hi[c] = fmaxf(u.hi[c], v.hi[c]);
  }
}

// Strict AABB overlap (collision.cl:164-166) of any two row types.
template <class A, class B>
__device__ __forceinline__ bool meets(const A& a, const B& b) {
  return (a.hi[0] > b.lo[0]) & (a.lo[0] < b.hi[0]) &
         (a.hi[1] > b.lo[1]) & (a.lo[1] < b.hi[1]) &
         (a.hi[2] > b.lo[2]) & (a.lo[2] < b.hi[2]);
}

// An int whose order is the float's for every non-NaN value (-0 just
// below +0), so a warp takes a float min or max in one redux.sync.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The union of the lanes' unions, in every lane of the warp.
__device__ __forceinline__ Box warp_union(Box u) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u.lo[c] = from_key(__reduce_min_sync(FULL, order_key(u.lo[c])));
    u.hi[c] = from_key(__reduce_max_sync(FULL, order_key(u.hi[c])));
  }
  return u;
}

}  // namespace cull
