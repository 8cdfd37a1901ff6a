"""Adversarial scenes through the port's engines, against the numpy oracle.

tests/test_adversarial.py's battery: clustered blobs and power-law radii
(cell sizing, window depth), a lattice whose boxes touch exactly and the
same lattice nudged to overlap (the strict test's ties), magnitudes of
1e8 (float32 precision), planar, collinear and duplicate-heavy scenes
(degenerate axes, sort ties), and four fuzz seeds. Each scene runs
through the slab, column, hetero (n > 64) and grid engines and the
run-expansion fill in float32 and float64, each walking its ``ok``
ladder as the Collider's retries do; the rung that reports ``ok`` must
give the oracle's pair set. No JAX here: the JAX suite holds JAX to the
same oracle, and tests/test_torch_cuda.py runs :func:`check_engines` on
the card.
"""

import numpy as np
import pytest
import torch

from collision_tpu_torch import collide
from collision_tpu_torch.fill import candidate_count, run_fill
from collision_tpu_torch.kernels.sweep import RPW_LADDER
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


def _clustered():
    rng = np.random.RandomState(1)
    centers = rng.random((5, 3))
    coords = np.concatenate(
        [c + rng.normal(0, 0.01, (40, 3)) for c in centers]).astype("float32")
    return coords, rng.uniform(0, 0.02, len(coords)).astype("float32"), 8


def _power_law():
    rng = np.random.RandomState(2)
    coords = rng.random((150, 3)).astype("float32")
    radii = (0.002 / rng.power(0.5, 150)).clip(0, 0.5).astype("float32")
    return coords, radii, 4


def _lattice(radius):
    def make():
        g = np.arange(4, dtype="float32")
        coords = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
        return coords, np.full(len(coords), radius, "float32"), 8
    return make


def _huge():
    rng = np.random.RandomState(3)
    coords = (rng.random((120, 3)) * 1e6 + 1e8).astype("float32")
    return coords, rng.uniform(1e3, 1e4, 120).astype("float32"), 8


def _planar():
    rng = np.random.RandomState(5)
    coords = rng.random((130, 3)).astype("float32")
    coords[:, 2] = 0.0
    return coords, rng.uniform(0, 0.08, 130).astype("float32"), 8


def _collinear():
    rng = np.random.RandomState(6)
    coords = np.zeros((100, 3), "float32")
    coords[:, 0] = np.sort(rng.random(100)).astype("float32")
    return coords, rng.uniform(0, 0.02, 100).astype("float32"), 8


def _duplicates():
    rng = np.random.RandomState(7)
    base = rng.random((10, 3)).astype("float32")
    coords = base[rng.randint(0, 10, 120)]
    return coords, rng.uniform(0, 0.1, 120).astype("float32"), 8


def _fuzz(seed):
    def make():
        rng = np.random.RandomState(100 + seed)
        n = int(rng.randint(2, 400))
        scale = 10.0 ** rng.uniform(-3, 3)
        coords = (rng.random((n, 3)) * scale).astype("float32")
        radii = (rng.random(n) * scale * rng.uniform(0.001, 0.2)).astype(
            "float32")
        return coords, radii, int(rng.choice([2, 4, 8, 16]))
    return make


#: name -> () -> (coords, radii, grid_dim), float32 numpy.
SCENES = {
    "clustered_blobs": _clustered,
    "power_law_radii": _power_law,
    "lattice_touching": _lattice(0.5),      # boxes touch: no pair
    "lattice_nudged": _lattice(0.5001),     # every neighbour overlaps
    "huge_magnitudes": _huge,
    "planar": _planar,
    "collinear": _collinear,
    "many_duplicates": _duplicates,
    **{f"fuzz_{s}": _fuzz(s) for s in range(4)},
}


def _first_ok(attempts):
    """The first result of a knob ladder that reports ``ok``."""
    for attempt in attempts:
        res = attempt()
        if bool(res.ok):
            return res
    raise AssertionError("no rung of the ladder reached ok=True")


def _check(count, pairs, expected, label):
    assert int(count) == len(expected), label
    assert pair_array_to_set(pairs.cpu(), count) == expected, label
    assert bool((pairs[len(expected):] == 0xFFFFFFFF).all()), label


def check_engines(coords, radii, grid_dim, device):
    """Every engine on one scene on ``device``: each rung that reports
    ``ok`` equals the oracle (float64 boxes for the float64 steps).
    Returns the float32 pair count."""
    n = len(coords)
    expected = brute_force_collisions(coords, radii)
    cap = len(expected) + 8
    c = torch.from_numpy(coords).to(device)
    r = torch.from_numpy(radii).to(device)

    # Slab: the default grid, then the single slab no capacity can fail.
    # Column and hetero: the rows-per-window rungs.
    ladders = {
        "slab": [dict(gx=gx) for gx in (None, 1)],
        "column": [dict(rpw=rpw) for rpw in RPW_LADDER[:8]],
        "hetero": [dict(rpw=rpw) for rpw in RPW_LADDER[:8]] if n > 64 else [],
    }
    for method, rungs in ladders.items():
        if rungs:
            res = _first_ok(lambda kw=kw: collide(c, r, cap, method=method,
                                                  **kw) for kw in rungs)
            _check(res.count, res.pairs, expected, method)
    # Grid: cell capacities doubling from 8 up to n, which cannot overflow.
    grid = _first_ok(lambda cc=cc: collide(c, r, cap, method="grid",
                                           grid_dim=grid_dim, cell_capacity=cc)
                     for cc in [8 << k for k in range(n.bit_length())
                                if 8 << k < n] + [n])
    _check(grid.count, grid.pairs, expected, "grid")

    # The run-expansion fill at the counted candidate bound: float32
    # directly, float64 through collide (count-only and fill).
    gxy = max(grid_dim // 2, 1)
    cand = int(candidate_count(c, r, gxy)) + 64
    pairs, total, ok = run_fill(c, r, cap, gxy, cand)
    assert bool(ok)
    _check(total, pairs, expected, "run_fill float32")
    c64, r64 = c.double(), r.double()
    want = brute_force_collisions(coords.astype("float64"),
                                  radii.astype("float64"))
    cand = int(candidate_count(c64, r64, gxy)) + 64
    for capacity in (0, len(want) + 8):
        res = collide(c64, r64, capacity, method="column", gxy=gxy,
                      cand_capacity=cand)
        assert bool(res.ok) and int(res.count) == len(want)
        if capacity:
            _check(res.count, res.pairs, want, "float64")
    return len(expected)


@pytest.mark.parametrize("name", list(SCENES))
def test_adversarial_scene(name):
    coords, radii, grid_dim = SCENES[name]()
    count = check_engines(coords, radii, grid_dim, "cpu")
    if name.startswith("lattice"):
        assert (count == 0) == (name == "lattice_touching")
