"""Numpy oracles for parity testing (collision_tpu/testing/oracle.py).

A copy, not an import: ``import collision_tpu.testing`` imports JAX,
which the port must run without.

Both oracles use the reference's semantics: strict componentwise overlap
of the center +- radius boxes, each unordered pair of original ids once,
no self-pairs, as a set of (smaller id, larger id). The boxes are
float64 when centers and radii both are, float32 otherwise.
"""

import numpy as np


def _boxes(coords, radii):
    coords, radii = np.asarray(coords), np.asarray(radii)
    dt = np.float64 if coords.dtype == radii.dtype == np.float64 \
        else np.float32
    coords = coords.astype(dt)
    radii = radii.astype(dt).reshape(-1, 1)
    return coords - radii, coords + radii


def brute_force_collisions(coords, radii):
    """Exact pair set by the O(N^2) all-pairs test (small n only)."""
    lo, hi = _boxes(coords, radii)
    overlap = (hi[:, None, :] > lo[None, :, :]) & (lo[:, None, :] < hi[None, :, :])
    overlap = np.tril(overlap.all(axis=-1), -1)
    ii, jj = np.nonzero(overlap)
    return {(int(b), int(a)) for a, b in zip(ii, jj)}


def kdtree_collisions(coords, radii, levels=16):
    """Exact pair set at any n and any radius distribution.

    The spheres are split into radius levels: level L holds the radii in
    (r_max / 2^(L+1), r_max / 2^L], the last level everything smaller.
    For each pair, the sphere of the lower level (the larger radius
    bound t) has its partner within Chebyshev distance r_i + r_j <= 2t of
    its center, so one k-d tree query per level, each level's spheres
    against all spheres at reach 2t (plus float32 rounding slack), lists
    a superset of the overlapping pairs, and the strict box test filters
    it. The queries stay near the size of the answer on power-law radii,
    where one query at 2*r_max would list billions of candidates.
    """
    from scipy.spatial import cKDTree

    lo, hi = _boxes(coords, radii)
    c64 = np.asarray(coords, dtype=np.float64)
    r = np.asarray(radii, dtype=np.float64)
    if len(r) < 2:
        return set()
    slack = 1e-5 * (1.0 + float(np.abs(c64).max()))
    t = max(float(r.max()), 0.0) / 2.0 ** np.arange(levels)
    # level = the largest L with r <= t[L]
    level = (r[:, None] <= t[None, 1:]).sum(axis=1)
    tree = cKDTree(c64)
    cand = []
    for lv in np.unique(level):
        idx = np.nonzero(level == lv)[0]
        near = cKDTree(c64[idx]).sparse_distance_matrix(
            tree, 2.0 * t[lv] * (1 + 1e-6) + slack, p=np.inf,
            output_type="ndarray")
        cand.append(np.stack([idx[near["i"]], near["j"]], axis=1))
    cand = np.concatenate(cand)
    i, j = cand[:, 0], cand[:, 1]
    keep = (i != j) & ((hi[i] > lo[j]) & (lo[i] < hi[j])).all(axis=1)
    a, b = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    return set(zip(a.tolist(), b.tolist()))


def pair_array_to_set(pairs, count):
    """Normalize a [capacity, 2] pair buffer to a set of sorted tuples."""
    pairs = np.sort(np.asarray(pairs)[: int(count)], axis=1)
    return {tuple(map(int, p)) for p in pairs}
