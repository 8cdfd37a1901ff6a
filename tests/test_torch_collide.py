"""Port parity: collision_tpu_torch.collide against the JAX package's
collide (methods "slab", "column" and "auto") with its Pallas kernels in
interpret mode, and on its run-expansion paths (float64, hetero at n <=
64), and against the numpy oracle. Count and ok must be equal
and the pair buffers bit-identical (the order is deterministic in both
packages); where ``ok`` is False the results are void and only ``ok`` is
compared. ``auto``'s radius-spread probe is compared within a float32
tolerance: its sums run in another order than XLA's."""

import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu import collider as jcollider
from collision_tpu_torch import collide, collider
from collision_tpu_torch.hetero import default_nb
from collision_tpu_torch.testing import (brute_force_collisions, kdtree_collisions,
                                        pair_array_to_set)


def _scene(n, r_max, seed):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, r_max, n).astype("float32")
    return coords, radii


def _port(coords, radii, capacity, gx=None):
    return collide(torch.from_numpy(coords), torch.from_numpy(radii),
                   capacity, method="slab", gx=gx)


@pytest.mark.parametrize("n,r_max,seed,gx,truncate", [
    (800, 1.2 / np.sqrt(800), 21, None, False),
    (3000, 1 / np.sqrt(3000), 4, None, False),
    (900, 0.12, 17, 2, True),   # residual pairs appended, then truncated
])
def test_collide_matches_jax(n, r_max, seed, gx, truncate):
    coords, radii = _scene(n, r_max, seed)
    expected = brute_force_collisions(coords, radii)
    capacities = [0, len(expected) + 8] + [len(expected) - 100] * truncate
    for capacity in capacities:
        want = collision_tpu.collide(coords, radii, capacity, method="slab",
                                     gx=gx, kernel_mode="interpret")
        got = _port(coords, radii, capacity, gx)
        assert bool(got.ok) == bool(want.ok) and bool(got.ok)
        assert int(got.count) == int(want.count) == len(expected)
        assert got.count.dtype == torch.int64
        np.testing.assert_array_equal(got.scene_min.numpy(), np.asarray(want.scene_min))
        if capacity == 0:
            assert got.pairs is None and want.pairs is None
            continue
        assert got.pairs.dtype == torch.int64
        np.testing.assert_array_equal(
            got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))


def test_collide_oracle_and_truncation():
    coords, radii = _scene(1500, 1.5 / np.sqrt(1500), 8)
    expected = brute_force_collisions(coords, radii)
    assert int(_port(coords, radii, 0).count) == len(expected)
    full = _port(coords, radii, len(expected) + 5)
    assert pair_array_to_set(full.pairs, full.count) == expected
    assert (full.pairs[len(expected):].numpy() == 0xFFFFFFFF).all()
    assert not full.overflowed
    cap = len(expected) - 7
    cut = _port(coords, radii, cap)
    assert int(cut.count) == len(expected) and cut.overflowed
    got = pair_array_to_set(cut.pairs, cap)
    assert len(got) == cap and got <= expected


def test_collide_single_sphere():
    coords, radii = _scene(1, 0.1, 0)
    res = _port(coords, radii, 4)
    assert int(res.count) == 0 and bool(res.ok)
    assert (res.pairs.numpy() == 0xFFFFFFFF).all() and res.pairs.shape == (4, 2)
    assert _port(coords, radii, 0).pairs is None


@pytest.mark.parametrize("kwargs", [{"method": "bvh"}])
def test_collide_unported_paths_raise(kwargs):
    coords, radii = _scene(kwargs.get("n", 100), 0.05, 0)
    dtype = kwargs.get("dtype", torch.float32)
    with pytest.raises(NotImplementedError):
        collide(torch.from_numpy(coords).to(dtype), torch.from_numpy(radii).to(dtype),
                kwargs.get("capacity", 0), method=kwargs.get("method", "slab"))


@pytest.mark.parametrize("kwargs", [
    {"dtype": "float64"},
    {"method": "hetero", "n": 64},   # the run-expansion fill, in both packages
    {"method": "hetero", "n": 64, "dtype": "float64"},
    {"method": "grid", "dtype": "float64", "capacity": 16},   # to "column"
])
def test_run_fill_paths_match_jax(kwargs):
    # The paths the JAX package serves with its run-expansion fill.
    coords, radii = _scene(kwargs.get("n", 100), 0.05, 0)
    dtype = kwargs.get("dtype", "float32")
    coords, radii = coords.astype(dtype), radii.astype(dtype)
    method = kwargs.get("method", "slab")
    expected = brute_force_collisions(coords, radii)
    for capacity in (0, kwargs.get("capacity", len(expected) + 4)):
        want = collision_tpu.collide(coords, radii, capacity, method=method)
        got = collide(torch.from_numpy(coords), torch.from_numpy(radii),
                      capacity, method=method)
        assert bool(got.ok) == bool(want.ok) and bool(got.ok)
        assert int(got.count) == int(want.count) == len(expected)
        if capacity:
            np.testing.assert_array_equal(
                got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))


def test_collide_unknown_method_raises():
    coords, radii = _scene(100, 0.05, 0)
    with pytest.raises(ValueError, match="Unknown method"):
        collide(torch.from_numpy(coords), torch.from_numpy(radii), 0,
                method="kdtree")


@pytest.mark.parametrize("n,r_max,seed,knobs,capacities", [
    # capacities: count-only, room for every pair, truncated
    (800, 1.2 / np.sqrt(800), 21, {}, (0, 8, -100)),
    # windows of 2-3 rows at rpw=1: both packages say ok=False
    (900, 0.12, 17, {"gxy": 2, "rpw": 1}, (0, 8)),
])
def test_column_collide_matches_jax(n, r_max, seed, knobs, capacities):
    # "auto" takes the column engine below 16384 spheres in both
    # packages, so the port's column and auto results are held to the
    # same JAX column result.
    coords, radii = _scene(n, r_max, seed)
    expected = brute_force_collisions(coords, radii)
    exact = knobs.get("rpw") != 1
    for extra in capacities:
        capacity = extra and len(expected) + extra
        want = collision_tpu.collide(coords, radii, capacity, method="column",
                                     kernel_mode="interpret", **knobs)
        for method in ("column", "auto"):
            got = collide(torch.from_numpy(coords), torch.from_numpy(radii),
                          capacity, method=method, **knobs)
            assert bool(got.ok) == bool(want.ok) == exact
            assert (got.pairs is None) == (capacity == 0)
            if not exact:
                continue
            assert int(got.count) == int(want.count) == len(expected)
            if capacity:
                np.testing.assert_array_equal(
                    got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))
                assert pair_array_to_set(
                    got.pairs, min(capacity, len(expected))) <= expected


def _probe_scene(kind, n=16384, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    if kind == "power_law":
        radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.35)
    else:
        radii = rng.uniform(0, 1 / np.sqrt(n), n)
    return coords, radii.astype("float32")


@pytest.mark.parametrize("kind,hetero", [("uniform", False),
                                         ("power_law", True)])
def test_hetero_probe_matches_jax(kind, hetero):
    coords, radii = _probe_scene(kind)
    nb = default_nb(len(radii))
    assert nb == jcollider._effective_nb(len(radii), None)
    got = collider._hetero_stats(torch.from_numpy(coords),
                                 torch.from_numpy(radii), nb)
    want = np.asarray(jcollider._hetero_stats(coords, radii, nb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    route = collider._route_hetero_eager(torch.from_numpy(coords),
                                         torch.from_numpy(radii))
    jroute = jcollider._route_hetero_eager(coords, radii, "interpret")
    assert (route is not None) == (jroute is not None) == hetero
    if hetero:
        np.testing.assert_allclose(route[:2], jroute[:2], rtol=1e-5)


def test_auto_runs_hetero_on_heterogeneous_scenes():
    # Below HETERO_SLAB_MIN "auto" keeps the caller's column knobs: the
    # default two rows per window are too few for this scene's parked
    # windows (ok False, never a silent answer), four are enough.
    coords, radii = _probe_scene("power_law")
    expected = kdtree_collisions(coords, radii)
    args = (torch.from_numpy(coords), torch.from_numpy(radii))
    assert not bool(collide(*args, 0).ok)
    count = collide(*args, 0, rpw=4)
    assert bool(count.ok) and int(count.count) == len(expected)
    fill = collide(*args, len(expected) + 8, rpw=4)
    assert bool(fill.ok) and pair_array_to_set(fill.pairs, fill.count) == expected


@pytest.mark.parametrize("kind,seed", [("power_law", 0), ("giant", 1),
                                       ("uniform", 2), ("zero", 3)])
def test_kdtree_oracle_matches_brute_force(kind, seed):
    rng = np.random.RandomState(seed)
    coords = rng.random((2000, 3)).astype("float32")
    if kind == "power_law":
        radii = (0.004 * (1 + rng.pareto(1.2, 2000))).clip(0, 0.35)
    elif kind == "giant":
        radii = rng.uniform(0, 0.02, 2000)
        radii[5] = 0.6
    elif kind == "uniform":
        radii = rng.uniform(0, 1 / np.sqrt(2000), 2000)
    else:
        radii = np.zeros(2000)
    radii = radii.astype("float32")
    assert kdtree_collisions(coords, radii) == brute_force_collisions(coords, radii)


@pytest.mark.parametrize("capacity,threshold", [
    (0, "SLAB_AUTO_THRESHOLD"), (16, "SLAB_FILL_AUTO_THRESHOLD")])
def test_auto_routes_at_the_crossovers(monkeypatch, capacity, threshold):
    for name in (threshold, "HETERO_AUTO_MIN", "SLAB_SLACK_MAX",
                 "HETERO_GAIN_MIN", "DEFAULT_RPW"):
        assert getattr(collider, name) == getattr(jcollider, name), name
    coords, radii = _scene(300, 0.05, 3)
    calls = []
    monkeypatch.setattr(collider, "_slab_collide",
                        lambda *args: calls.append("slab"))
    monkeypatch.setattr(collider, "_column_collide",
                        lambda *args: calls.append("column"))
    for at, engine in ((301, "column"), (300, "slab")):
        monkeypatch.setattr(collider, threshold, at)
        collide(torch.from_numpy(coords), torch.from_numpy(radii), capacity)
        assert calls[-1] == engine
