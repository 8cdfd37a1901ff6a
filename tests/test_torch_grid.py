"""Port parity: the grid engine (collision_tpu_torch.grid and
``collide(method="grid")``) against the JAX package's on the same numpy
scenes, with exact equality: bins bit for bit, ids, ``ok``, totals, tile
counts and pair buffers; and ``Collider(method="grid")``'s retry against
JAX's under ``interpret_kernels()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu import collider as jcollider
from collision_tpu import grid as jgrid
from collision_tpu_torch import (Collider, GridCounts, build_grid, collide,
                                 collider, grid_count)
from collision_tpu_torch import grid
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


def _random(n, rscale, dtype="float32"):
    rng = np.random.RandomState(n)
    coords = rng.random((n, 3)).astype(dtype)
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype(dtype)
    return coords, radii


def _ones(r):
    return np.ones((20, 3), "float32"), np.full(20, r, "float32")


def _halo_hugging():
    coords = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.01, 0.0, 0.0],
                       [1.0, 0.99, 1.0]], dtype="float32")
    return coords, np.full(4, 0.02, "float32")


# The scenes of tests/test_grid.py: (make, args, grid_dim, cell_capacity).
SCENES = {
    "random_100": (_random, (100, 1.0), 8, 16),
    "random_341": (_random, (341, 1.0), 8, 32),
    "random_1000": (_random, (1000, 1.0), 16, 32),
    "big_radii": (_random, (1000, 4.0), 4, 128),
    "nearly_one_cell": (_random, (50, 8.0), 2, 64),
    "identical": (_ones, (1.0,), 4, 32),
    "zero_radii": (_ones, (0.0,), 4, 32),
    "cell_overflow": (_ones, (1.0,), 4, 8),
    "halo_hugging": (_halo_hugging, (), 8, 8),
}


def _scene(name):
    make, args, gd, mc = SCENES[name]
    coords, radii = make(*args)
    return coords, radii, gd, mc


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def test_half_offsets_match_jax():
    assert grid._HALF_OFFSETS == jgrid._HALF_OFFSETS
    assert grid.TILE_OFFSETS == ((0, 0, 0),) + jgrid._HALF_OFFSETS


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_grid_matches_jax(name):
    coords, radii, gd, mc = _scene(name)
    jbins, jok, jids = jgrid.build_grid(jnp.asarray(coords),
                                        jnp.asarray(radii), gd, mc)
    # build_grid takes the plain path on a CPU tensor; the plain path is
    # what the card's kernel chain is held to (tests/test_torch_cuda.py).
    for build in (build_grid, grid.build_grid_plain):
        bins, ok, ids = build(torch.from_numpy(coords),
                              torch.from_numpy(radii), gd, mc)
        assert bins.shape == jbins.shape and bins.dtype == torch.float32
        np.testing.assert_array_equal(_bits(bins.numpy()), _bits(jbins))
        assert bool(ok) == bool(jok) == (name != "cell_overflow")
        np.testing.assert_array_equal(ids.numpy(),
                                      np.asarray(jids).astype(np.int64))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_grid_count_matches_jax(name):
    coords, radii, gd, mc = _scene(name)
    want = jgrid.grid_count(jnp.asarray(coords), jnp.asarray(radii),
                            grid_dim=gd, cell_capacity=mc)
    got = grid_count(torch.from_numpy(coords), torch.from_numpy(radii),
                     grid_dim=gd, cell_capacity=mc)
    assert isinstance(got, GridCounts)
    assert bool(got.ok) == bool(want.ok)
    assert got.total.dtype == torch.int64 and got.tile_counts.dtype == torch.int32
    assert int(got.total) == int(want.total)
    np.testing.assert_array_equal(got.tile_counts.numpy(),
                                  np.asarray(want.tile_counts))
    if bool(got.ok):
        assert int(got.total) == len(brute_force_collisions(coords, radii))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_build_grid_takes_no_sphere(dtype):
    # No sphere: every slot a +inf row, ok, no id; the same on the card
    # (tests/test_torch_cuda.py).
    bins, ok, ids = build_grid(torch.zeros((0, 3), dtype=dtype),
                               torch.zeros((0,), dtype=dtype), 5, 16)
    assert bins.shape == (7, 7, 7, 16, 8) and bins.dtype == dtype
    assert bool(torch.isposinf(bins).all()) and bool(ok)
    assert ids.dtype == torch.int64 and ids.numel() == 0


def test_float64_grid_matches_jax():
    coords, radii = _random(500, 0.05 * np.sqrt(500), "float64")
    jbins, jok, _ = jgrid.build_grid(jnp.asarray(coords), jnp.asarray(radii),
                                     8, 64)
    bins, ok, _ = build_grid(torch.from_numpy(coords), torch.from_numpy(radii),
                             8, 64)
    assert bins.dtype == torch.float64
    np.testing.assert_array_equal(_bits(bins.numpy()), _bits(jbins))
    got = grid_count(torch.from_numpy(coords), torch.from_numpy(radii), 8, 64)
    want = jgrid.grid_count(jnp.asarray(coords), jnp.asarray(radii), 8, 64)
    assert bool(got.ok) == bool(want.ok) and bool(ok) == bool(jok)
    assert int(got.total) == int(want.total) \
        == len(brute_force_collisions(coords, radii))


@pytest.mark.parametrize("n", [1, 50, 2000, 65536, 1_000_000, 10 ** 8])
def test_default_grid_config_matches_jax(n):
    assert collider.default_grid_config(n) == jcollider.default_grid_config(n)
    assert collider.default_grid_dim(n) == jcollider.default_grid_dim(n)


@pytest.mark.parametrize("n,rscale,knobs,extras", [
    # extras: count-only, room for every pair, a cut (pairs - extra)
    (800, 1.5, {}, (0, 8)),
    # odd grid_dim (the halo count), pinned knobs, truncated fill
    (1000, 1.0, {"grid_dim": 7, "cell_capacity": 24}, (0, -60)),
])
def test_grid_collide_matches_jax(n, rscale, knobs, extras):
    coords, radii = _random(n, rscale)
    expected = brute_force_collisions(coords, radii)
    for extra in extras:
        capacity = extra and len(expected) + extra
        want = collision_tpu.collide(coords, radii, capacity, method="grid",
                                     **knobs)
        got = collide(torch.from_numpy(coords), torch.from_numpy(radii),
                      capacity, method="grid", **knobs)
        assert bool(got.ok) and bool(want.ok)
        assert int(got.count) == int(want.count) == len(expected)
        assert got.count.dtype == torch.int64
        if capacity == 0:
            assert got.pairs is None and want.pairs is None
            continue
        np.testing.assert_array_equal(
            got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))
        kept = min(capacity, len(expected))
        assert pair_array_to_set(got.pairs, kept) <= expected
        assert (got.pairs[kept:].numpy() == 0xFFFFFFFF).all()


def _clustered(n, seed, r):
    # Every sphere inside one tiny xy patch: the default grid piles them
    # into a column of gd cells, far past the default cell capacity.
    np.random.seed(seed)
    coords = np.random.random((n, 3)).astype(np.float32)
    coords[:, :2] *= 1e-3
    return coords, np.full(n, r, np.float32)


def test_collider_grid_retry_matches_jax():
    n = 2000
    coords, radii = _clustered(n, 11, 5e-4)
    expected = brute_force_collisions(coords, radii)
    first = collide(torch.from_numpy(coords), torch.from_numpy(radii), 0,
                    method="grid")
    jfirst = collision_tpu.collide(coords, radii, 0, method="grid")
    assert not bool(first.ok) and not bool(jfirst.ok)
    capacity = len(expected) + 16
    with collision_tpu.interpret_kernels():
        want = collision_tpu.Collider(n, method="grid").get_collisions(
            coords, radii, capacity)
    count, pairs = Collider(n, method="grid", device="cpu").get_collisions(
        coords, radii, capacity)
    assert int(count) == int(want[0]) == len(expected)
    np.testing.assert_array_equal(pairs.numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    assert pair_array_to_set(pairs, count) == expected
