"""Port parity: the hetero engine (collision_tpu_torch.hetero) and
``collide``'s routing to it, against the JAX package's with its Pallas
kernels in interpret mode, on the scenes of tests/test_hetero.py: counts,
``ok`` and pair buffers bit-identical (the order is deterministic in both
packages); where ``ok`` is False on both sides the results are void and
only ``ok`` is compared. Each JAX result is computed once per module, at
one fixed ``rpw`` per case (no retry ladder)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu import collider as jcollider
from collision_tpu import hetero as jhetero
from collision_tpu_torch import collide, collider, hetero
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


def _scene(name):
    """(coords, radii, nb) of the JAX package's hetero test scenes."""
    if name == "power_law":
        rng = np.random.RandomState(0)
        coords = rng.random((1500, 3)).astype("float32")
        radii = (0.004 * (1 + rng.pareto(1.2, 1500))).clip(0, 0.35)
        return coords, radii.astype("float32"), 128
    if name == "giant":
        rng = np.random.RandomState(1)
        coords = rng.random((800, 3)).astype("float32")
        radii = rng.uniform(0, 0.02, 800).astype("float32")
        radii[17] = 0.4
        return coords, radii, 64
    rng = np.random.RandomState(2)          # big-big overlaps
    coords = rng.random((600, 3)).astype("float32")
    radii = rng.uniform(0, 0.01, 600).astype("float32")
    radii[100:110] = rng.uniform(0.2, 0.3, 10)
    return coords, radii, 64


@functools.cache
def _expected(name):
    coords, radii, _ = _scene(name)
    return brute_force_collisions(coords, radii)


@pytest.fixture(scope="module")
def jax_hetero():
    """JAX ``hetero_collide`` in interpret mode, each (scene, engine,
    rpw, capacity) computed once per module."""
    @functools.cache
    def run(name, engine, rpw, capacity):
        coords, radii, nb = _scene(name)
        pairs, total, ok = jhetero.hetero_collide(
            jnp.asarray(coords), jnp.asarray(radii), capacity, nb=nb,
            rpw=rpw, interpret=True, engine=engine)
        return (None if pairs is None else np.asarray(pairs).astype(np.int64),
                int(total), bool(ok))
    return run


# (scene, engine, rpw, capacities): "full" has room for every pair,
# "half" and "cut5" truncate inside the S-S and the last segments.
CASES = [
    ("power_law", "column", 2, ("count", "full", "half")),
    ("power_law", "slab", 1, ("count", "full", "cut5")),
    ("giant", "slab", 1, ("count", "full")),
    ("giant", "column", 1, ("full",)),     # one aligned row: ok False
    ("big_big", "column", 2, ("count", "full")),
]


def _capacity(name, which):
    total = len(_expected(name))
    return {"count": 0, "full": total + 16, "half": total // 2,
            "cut5": total - 5}[which]


@pytest.mark.parametrize("name,engine,rpw,capacities", CASES)
def test_hetero_collide_matches_jax(jax_hetero, name, engine, rpw,
                                    capacities):
    coords, radii, nb = _scene(name)
    expected = _expected(name)
    for which in capacities:
        capacity = _capacity(name, which)
        want_pairs, want_total, want_ok = jax_hetero(name, engine, rpw,
                                                     capacity)
        pairs, total, ok = hetero.hetero_collide(
            torch.from_numpy(coords), torch.from_numpy(radii), capacity,
            nb=nb, rpw=rpw, engine=engine)
        assert bool(ok) == want_ok, which
        assert (pairs is None) == (capacity == 0)
        if not want_ok:
            continue
        assert total.dtype == torch.int64
        assert int(total) == want_total == len(expected)
        if capacity:
            assert pairs.dtype == torch.int64
            np.testing.assert_array_equal(pairs.numpy(), want_pairs)
            got = pair_array_to_set(pairs, min(capacity, len(expected)))
            assert got <= expected and len(got) == min(capacity, len(expected))


def test_hetero_slab_flags_split_ok():
    coords, radii, nb = _scene("giant")
    args = (torch.from_numpy(coords), torch.from_numpy(radii))
    for capacity in (0, 64):
        pairs, total, ok, (gx_ok, other_ok) = hetero.hetero_collide(
            *args, capacity, nb=nb, engine="slab", with_flags=True)
        assert bool(ok) and bool(gx_ok) and bool(other_ok)
    with pytest.raises(ValueError, match="with_flags"):
        hetero.hetero_collide(*args, 0, nb=nb, with_flags=True)
    with pytest.raises(ValueError, match="n > 64"):
        hetero.hetero_collide(args[0][:64], args[1][:64], 0)
    # collide() serves n <= 64 with the run-expansion fill, as JAX does.
    small = collide(args[0][:64], args[1][:64], 0, method="hetero")
    assert bool(small.ok)
    assert int(small.count) == len(brute_force_collisions(coords[:64],
                                                          radii[:64]))


def test_quantize_gx_matches_jax():
    for gx in list(range(0, 5000)) + [10 ** 5]:
        assert collider._quantize_gx(gx) == jcollider._quantize_gx(gx), gx


def test_effective_nb_matches_jax():
    for n in (65, 100, 640, 1000, 16384, 10 ** 6):
        for nb in (None, 1, 64, 100, 1024, 5000):
            assert collider._effective_nb(n, nb) \
                == jcollider._effective_nb(n, nb), (n, nb)


def test_hetero_route_knobs_match_jax():
    rows = [
        # tests/test_hetero.py: the 1M power-law reference scene, and a
        # mild spread that keeps the slab dual dispatch
        (1_000_000, 1024, 0.01445, 0.00124, (1.0, 1.0, 1.0)),
        (1_000_000, 1024, 0.0012, 0.0005, (1.0, 1.0, 1.0)),
    ]
    for n in (1500, 16384, 100_000, 1_000_000):
        for r_small in (1e-4, 1e-3, 0.01445, 0.05):
            for r_mean in (0.0, 0.0005, 0.00124):
                for ext in ((1.0, 1.0, 1.0), (2.0, 0.5, 1.0), (1.0, 1.0, 0.0)):
                    rows.append((n, 1024, r_small, r_mean, ext))
    routes = set()
    for n, nb, r_small, r_mean, ext in rows:
        got = collider._hetero_route_knobs(n, nb, r_small, r_mean, ext)
        want = jcollider._hetero_route_knobs(n, nb, r_small, r_mean,
                                             np.array(ext))
        assert got == tuple(want), (n, r_small, r_mean, ext)
        routes.add(got[0])
    assert routes == {"slab", "column"}


def _routing_scene(route):
    # Power-law radii whose probe routes the S-S pass to the slab engine
    # (gx 4) or to the column engine (gxy 1, rpw 6) once the thresholds
    # are lowered to n = 256.
    n, seed, shape, r0, clip = ((1200, 7, 1.2, 0.004, 0.3) if route == "slab"
                                else (1500, 5, 2.0, 0.02, 0.2))
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = (r0 * (1 + rng.pareto(shape, n))).clip(0, clip).astype("float32")
    return coords, radii


@pytest.mark.parametrize("route,capacity", [("slab", 8), ("column", 0)])
def test_auto_routes_hetero_like_jax(monkeypatch, route, capacity):
    coords, radii = _routing_scene(route)
    expected = brute_force_collisions(coords, radii)
    capacity = capacity and len(expected) + capacity
    for mod in (collider, jcollider):
        monkeypatch.setattr(mod, "HETERO_AUTO_MIN", 256)
        monkeypatch.setattr(mod, "HETERO_SLAB_MIN", 256)
    calls = {}

    def spy(key, real):
        def wrapped(*args, **kwargs):
            kwargs.pop("interpret", None)
            calls[key] = kwargs
            return real(*args, **kwargs) if key == "port" \
                else real(*args, interpret=True, **kwargs)
        return wrapped

    monkeypatch.setattr(collider, "hetero_collide",
                        spy("port", collider.hetero_collide))
    monkeypatch.setattr(jhetero, "hetero_collide",
                        spy("jax", jhetero.hetero_collide))
    want = collision_tpu.collide(coords, radii, capacity,
                                 kernel_mode="interpret")
    got = collide(torch.from_numpy(coords), torch.from_numpy(radii), capacity)
    assert calls["port"] == calls["jax"]
    assert calls["port"].get("engine", "column") == route
    assert bool(got.ok) == bool(want.ok) and bool(got.ok)
    assert int(got.count) == int(want.count) == len(expected)
    if capacity:
        np.testing.assert_array_equal(
            got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))
