"""Numpy oracles for parity testing (collision_tpu/testing/oracle.py).

A copy, not an import: ``import collision_tpu.testing`` imports JAX,
which the port must run without.

Both oracles use the reference's semantics: strict componentwise overlap
of the float32 center +- radius boxes, each unordered pair of original
ids once, no self-pairs, as a set of (smaller id, larger id).
"""

import numpy as np


def _boxes(coords, radii):
    coords = np.asarray(coords, dtype=np.float32)
    radii = np.asarray(radii, dtype=np.float32).reshape(-1, 1)
    return coords - radii, coords + radii


def brute_force_collisions(coords, radii):
    """Exact pair set by the O(N^2) all-pairs test (small n only)."""
    lo, hi = _boxes(coords, radii)
    overlap = (hi[:, None, :] > lo[None, :, :]) & (lo[:, None, :] < hi[None, :, :])
    overlap = np.tril(overlap.all(axis=-1), -1)
    ii, jj = np.nonzero(overlap)
    return {(int(b), int(a)) for a, b in zip(ii, jj)}


def kdtree_collisions(coords, radii):
    """Exact pair set at any n: a k-d tree lists every pair whose centers
    lie within Chebyshev distance 2*r_max (plus float32 rounding slack),
    a superset of the overlapping pairs, and the strict box test filters
    it."""
    from scipy.spatial import cKDTree

    lo, hi = _boxes(coords, radii)
    c64 = np.asarray(coords, dtype=np.float64)
    reach = 2.0 * float(np.max(radii)) * (1 + 1e-6) \
        + 1e-5 * (1.0 + float(np.abs(c64).max()))
    cand = cKDTree(c64).query_pairs(reach, p=np.inf, output_type="ndarray")
    i, j = cand[:, 0], cand[:, 1]
    keep = ((hi[i] > lo[j]) & (lo[i] < hi[j])).all(axis=1)
    a, b = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    return set(zip(a.tolist(), b.tolist()))


def pair_array_to_set(pairs, count):
    """Normalize a [capacity, 2] pair buffer to a set of sorted tuples."""
    pairs = np.sort(np.asarray(pairs)[: int(count)], axis=1)
    return {tuple(map(int, p)) for p in pairs}
