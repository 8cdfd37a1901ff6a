"""Port parity: the reference's Collider API on the CPU (device="cpu").

The float32 cases of tests/test_collider.py against the numpy oracle;
on its two clustered scenes and on two scenes whose first step comes
back ``ok=False`` (so the column and the hetero retry ladders run), the
count and pairs must be bit-identical to the JAX package's Collider with
its Pallas kernels in interpret mode. The JAX suite's
``test_retry_terminates_on_unsplittable_cluster`` needs the BVH rung,
which waits for the LBVH port.
"""

import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu_torch import Collider, collide, collide_exact, collider
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


def _random_scene(size, coord_dtype="float32"):
    np.random.seed(4)
    coords = np.random.random((size, 3)).astype(coord_dtype)
    radius = 1 / (size ** 0.5)
    radii = np.random.uniform(0, radius, size).astype(coord_dtype)
    return coords, radii


def _collider(*args, **kwargs):
    return Collider(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("size,ngroups,group_size,expected", [
    (48, 3, 8, 48), (47, 3, 8, 48), (49, 3, 8, 64),
])
def test_padded_size(size, ngroups, group_size, expected):
    c = _collider(size, ngroups, group_size, "float32")
    assert c.padded_size == expected and c.n_nodes == 2 * size - 1


def test_collision():
    coords = np.array([
        [0.0, 1.0, 3.0],
        [0.0, 1.0, 3.0],
        [4.0, 1.0, 8.0],
        [-4.0, -6.0, 3.0],
        [-5.0, 0.0, -1.0],
        [-5.0, 0.5, -0.5],
    ], dtype="float32")
    radii = np.ones(len(coords), dtype="float32")
    count, pairs = _collider(len(coords), 3, 8).get_collisions(coords, radii, 2)
    assert int(count) == 2 and pairs.dtype == torch.int64
    assert pair_array_to_set(pairs, count) == {(0, 1), (4, 5)}


@pytest.mark.parametrize("size,ngroups,group_size", [
    (120, 5, 8), (256, 4, 32), (317, 4, 16), (341, 4, 64),
])
def test_random_collision(size, ngroups, group_size):
    coords, radii = _random_scene(size)
    expected = brute_force_collisions(coords, radii)
    count, pairs = _collider(size, ngroups, group_size).get_collisions(
        torch.from_numpy(coords), radii, len(expected))
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


@pytest.mark.parametrize("old_shape,new_shape", [
    ((350, 8, 64), (351, 8, 64)),
    ((350, 8, 64), (351, None, None)),
])
def test_random_collision_resized(old_shape, new_shape):
    c = _collider(*old_shape)
    c.resize(*new_shape)
    coords, radii = _random_scene(351)
    expected = brute_force_collisions(coords, radii)
    count, pairs = c.get_collisions(coords, radii, len(expected))
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


def test_count_only():
    coords, radii = _random_scene(100)
    count = _collider(100, 10, 8).get_collisions(coords, radii, 0,
                                                 collisions=None)
    assert int(count) == len(brute_force_collisions(coords, radii))


def test_count_err():
    coords, radii = _random_scene(100)
    with pytest.raises(ValueError):
        _collider(100, 5, 8).get_collisions(coords, radii, 10, collisions=None)


@pytest.mark.parametrize("dt", ["float32", np.dtype("float32"),
                                "float64", np.dtype("float64")])
def test_collider_dtype(dt):
    assert _collider(100, 5, 8, coord_dtype=dt).coord_dtype == np.dtype(dt)


def test_collider_invalid_dtype():
    with pytest.raises(ValueError):
        _collider(100, 5, 8, coord_dtype="uint32")


def test_collider_shape_validation():
    with pytest.raises(ValueError):
        _collider(10, 1, 8).get_collisions(np.zeros((11, 3), "float32"),
                                           np.zeros(11, "float32"), 0,
                                           collisions=None)


def test_float64_collider_matches_jax():
    # Float64 steps run the run-expansion fill in both packages.
    coords, radii = _random_scene(100, "float64")
    expected = brute_force_collisions(coords, radii)
    count, pairs = _collider(100, 5, 8, "float64").get_collisions(
        coords, radii, 64)
    want_count, want_pairs = collision_tpu.Collider(
        100, 5, 8, "float64").get_collisions(coords, radii, 64)
    assert int(count) == int(want_count) == len(expected)
    np.testing.assert_array_equal(pairs.numpy(),
                                  np.asarray(want_pairs).astype(np.int64))


def test_collider_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Collider(100)
    assert Collider(100, device="cpu").device == torch.device("cpu")


def test_overflow_count_exceeds_capacity():
    coords, radii = _random_scene(100)
    expected = brute_force_collisions(coords, radii)
    assert len(expected) > 2
    count, pairs = _collider(100, 5, 8).get_collisions(coords, radii, 2)
    assert int(count) == len(expected)
    assert tuple(pairs.shape) == (2, 2)
    assert pair_array_to_set(pairs, 2) <= expected


@pytest.mark.parametrize("bad", [
    {"size": 0}, {"size": -3}, {"size": 2.5},
    {"ngroups": 0}, {"ngroups": -1},
    {"group_size": 0}, {"group_size": 3}, {"group_size": 48},
    {"radix_bits": 5}, {"radix_bits": 0}, {"radix_bits": 64},
])
def test_resize_rejects_invalid_and_rolls_back(bad):
    c = _collider(100, 5, 8)
    with pytest.raises(ValueError):
        c.resize(**bad)
    assert (c.size, c.ngroups, c.group_size) == (100, 5, 8)


@pytest.mark.parametrize("bad", [
    {"size": 0}, {"ngroups": 0}, {"group_size": 12},
])
def test_constructor_rejects_invalid_params(bad):
    kwargs = {"size": 100, "ngroups": 5, "group_size": 8}
    kwargs.update(bad)
    with pytest.raises(ValueError):
        _collider(**kwargs)


def _clustered(n, seed, r):
    # Every sphere inside one tiny xy patch: one column holds all n.
    np.random.seed(seed)
    coords = np.random.random((n, 3)).astype(np.float32)
    coords[:, :2] *= 1e-3
    return coords, np.full(n, r, np.float32)


def _power_law(n, seed):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.35)
    return coords, radii.astype("float32")


@pytest.mark.parametrize("scene,fill,retries", [
    # The JAX package's two scenes (tests/test_collider.py): at gxy=1 the
    # default column capacity holds every sphere, so the first step is ok.
    ((_clustered, 2000, 11, 5e-4), False, False),
    ((_clustered, 1500, 12, 4e-4), True, False),
    # gxy=2: one column past the default capacity; the column ladder.
    ((_clustered, 4000, 13, 5e-4), True, True),
    # Mixed radii on the column engine: the hetero ladder.
    ((_power_law, 1500, 0), True, True),
])
def test_retry_matches_jax(scene, fill, retries):
    make, n, *rest = scene
    coords, radii = make(n, *rest)
    expected = brute_force_collisions(coords, radii)
    first = collide(torch.from_numpy(coords), torch.from_numpy(radii), 0,
                    method="column")
    assert bool(first.ok) != retries
    capacity = len(expected) + 16 if fill else 0
    collisions = True if fill else None
    with collision_tpu.interpret_kernels():
        want = collision_tpu.Collider(n, method="column").get_collisions(
            coords, radii, capacity, collisions=collisions)
    got = _collider(n, method="column").get_collisions(
        coords, radii, capacity, collisions=collisions)
    if fill:
        (count, pairs), (want_count, want_pairs) = got, want
        np.testing.assert_array_equal(
            pairs.numpy(), np.asarray(want_pairs).astype(np.int64))
        assert pair_array_to_set(pairs, count) == expected
    else:
        count, want_count = got, want
    assert int(count) == int(want_count) == len(expected)


def test_collide_exact_retries_and_keeps_the_device():
    coords, radii = _clustered(4000, 13, 5e-4)
    expected = brute_force_collisions(coords, radii)
    args = (torch.from_numpy(coords), torch.from_numpy(radii))
    res = collide_exact(*args, len(expected) + 4, method="column")
    assert bool(res.ok) and int(res.count) == len(expected)
    assert res.pairs.device == torch.device("cpu")
    assert pair_array_to_set(res.pairs, res.count) == expected
    assert collider.RPW_RETRY_MAX == collision_tpu.collider.RPW_RETRY_MAX
