"""Port parity: the run-expansion fill (``fill.run_fill``,
``candidate_count``) and the float64 steps it serves, against the JAX
package's, which runs the same fill as plain XLA on the CPU.

Counts and ``ok`` must be equal and pair buffers bit-identical: both
packages emit in sorted-sphere-major, offset-minor, ascending-j order.
The scenes are tests/test_fill.py's, in float32 and float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu import fill as jfill
from collision_tpu_torch import Collider, collide, fill
from collision_tpu_torch.collider import default_cand_capacity
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


def _scene(n, rscale, seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype(dtype)
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype(dtype)
    return coords, radii


def _both(coords, radii, capacity, gxy, cand=1 << 20):
    want = jfill.run_fill(jnp.asarray(coords), jnp.asarray(radii), capacity,
                          gxy, cand)
    got = fill.run_fill(torch.from_numpy(coords), torch.from_numpy(radii),
                        capacity, gxy, cand)
    return got, want


def _assert_same(got, want):
    (pairs, total, ok), (jpairs, jtotal, jok) = got, want
    assert total.dtype == torch.int64
    assert int(total) == int(jtotal) and bool(ok) == bool(jok)
    assert (pairs is None) == (jpairs is None)
    if pairs is not None:
        assert pairs.dtype == torch.int64
        np.testing.assert_array_equal(pairs.numpy(),
                                      np.asarray(jpairs).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,rscale,seed,gxy", [
    (64, 1.0, 0, 2),
    (317, 1.5, 1, 3),     # non-power-of-2
    (1000, 0.5, 2, 4),
    (1000, 0.5, 2, 1),    # single column
    (2048, 2.0, 3, 5),
    (5000, 1.2, 10, 6),
])
def test_run_fill_matches_jax(n, rscale, seed, gxy, dtype):
    coords, radii = _scene(n, rscale, seed, dtype)
    expected = brute_force_collisions(coords, radii)
    capacity = max(len(expected) + 7, 16)
    got, want = _both(coords, radii, capacity, gxy)
    _assert_same(got, want)
    pairs, total, ok = got
    assert bool(ok) and int(total) == len(expected)
    assert pair_array_to_set(pairs, total) == expected
    assert (pairs[len(expected):] == 0xFFFFFFFF).all()
    cand = fill.candidate_count(torch.from_numpy(coords),
                                torch.from_numpy(radii), gxy)
    jcand = float(jfill.candidate_count(jnp.asarray(coords),
                                        jnp.asarray(radii), gxy))
    assert cand.dtype == torch.int64
    assert abs(int(cand) - jcand) <= 2 ** -20 * jcand


def test_run_fill_truncated_and_count_only_match_jax():
    # The true total past capacity, the first `capacity` pairs real.
    coords, radii = _scene(200, 0.2 * np.sqrt(200), 3)
    expected = brute_force_collisions(coords, radii)
    for capacity in (5, 0):
        got, want = _both(coords, radii, capacity, 2)
        _assert_same(got, want)
        assert bool(got[2]) and int(got[1]) == len(expected)
        if capacity:
            assert pair_array_to_set(got[0], capacity) <= expected


def test_run_fill_candidate_overflow_matches_jax():
    # Past cand_capacity: ok=False and a correct prefix on both sides; the
    # counted bound makes it ok.
    coords, radii = _scene(200, 0.2 * np.sqrt(200), 3)
    got, want = _both(coords, radii, 5, 2, cand=64)
    _assert_same(got, want)
    assert not bool(got[2])
    needed = int(fill.candidate_count(torch.from_numpy(coords),
                                      torch.from_numpy(radii), 2))
    got, want = _both(coords, radii, 5, 2, cand=needed + 8)
    _assert_same(got, want)
    assert bool(got[2])


@pytest.mark.parametrize("kind", ["identical", "degenerate_z"])
def test_run_fill_degenerate_scenes_match_jax(kind):
    if kind == "identical":
        n, gxy, cand = 96, 4, 1 << 20
        coords = np.full((n, 3), 0.25, "float32")
        radii = np.full(n, 0.1, "float32")
    else:
        n, gxy, cand = 150, 3, 1 << 18
        coords, radii = _scene(n, 0.1 * np.sqrt(n), 8)
        coords[:, 2] = 0.5
    expected = brute_force_collisions(coords, radii)
    got, want = _both(coords, radii, len(expected) + 4, gxy, cand)
    _assert_same(got, want)
    assert bool(got[2]) and int(got[1]) == len(expected)
    if kind == "identical":
        assert len(expected) == n * (n - 1) // 2


@pytest.mark.parametrize("method,n,knobs", [
    ("column", 800, {}),
    ("column", 800, {"gxy": 3}),
    ("slab", 800, {}),
    ("hetero", 800, {}),
    ("auto", 800, {}),
    ("grid", 800, {}),          # count: the stencil; fill: the column method
])
def test_float64_collide_matches_jax(method, n, knobs):
    coords, radii = _scene(n, 1.2, 21, "float64")
    expected = brute_force_collisions(coords, radii)
    for capacity in (0, len(expected) + 8, len(expected) - 50):
        want = collision_tpu.collide(coords, radii, capacity, method=method,
                                     **knobs)
        got = collide(torch.from_numpy(coords), torch.from_numpy(radii),
                      capacity, method=method, **knobs)
        assert bool(got.ok) == bool(want.ok) and bool(got.ok)
        assert int(got.count) == int(want.count) == len(expected)
        assert got.scene_min.dtype == torch.float64
        if capacity:
            np.testing.assert_array_equal(
                got.pairs.numpy(), np.asarray(want.pairs).astype(np.int64))


def test_default_cand_capacity_matches_jax():
    for n, capacity in ((10, 0), (1000, 1 << 20), (1 << 20, 16)):
        assert default_cand_capacity(n, capacity) \
            == collision_tpu.collider.default_cand_capacity(n, capacity)


def test_float64_collider_retries_past_the_candidate_bound():
    # 1000 spheres at one point: 499,500 pairs, far past the default
    # 2^17 candidates, so the first step is not ok and the retry counts
    # the candidates the scene needs.
    coords = np.zeros((1000, 3))
    radii = np.full(1000, 0.1)
    first = collide(torch.from_numpy(coords), torch.from_numpy(radii), 1000)
    assert not bool(first.ok)
    count, pairs = Collider(1000, coord_dtype="float64",
                            device="cpu").get_collisions(coords, radii, 1000)
    want_count, want_pairs = collision_tpu.Collider(
        1000, coord_dtype="float64").get_collisions(coords, radii, 1000)
    assert int(count) == int(want_count) == 499_500
    np.testing.assert_array_equal(pairs.numpy(),
                                  np.asarray(want_pairs).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantize_saturates_as_jax(dtype):
    # The run fill quantizes z + r + r_max, which can pass the scene's z
    # extent by far; JAX's uint32 cast saturates there.
    from collision_tpu import columns as jcolumns
    from collision_tpu_torch import columns

    z = np.array([-5.0, 0.0, 0.5, 1.0, 3.0, 5e9, 1e30, np.inf], dtype)
    zmax = (1 << 23) - 1
    scale = np.asarray(zmax, dtype)
    want = np.asarray(jcolumns._quantize(jnp.asarray(z), jnp.asarray(z[1]),
                                         jnp.asarray(scale), zmax))
    got = columns._quantize(torch.from_numpy(z), torch.tensor(z[1]),
                            torch.from_numpy(scale), zmax)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
