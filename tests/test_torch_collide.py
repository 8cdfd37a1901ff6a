"""Port parity: collision_tpu_torch.collide against the JAX package's
collide(method="slab") with its Pallas kernels in interpret mode, and
against the numpy oracle. Count and ok must be equal and the pair buffers
bit-identical (the order is deterministic in both packages)."""

import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu_torch import collide
from collision_tpu_torch.fill import BIG_FILL_THRESHOLD
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set


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


@pytest.mark.parametrize("kwargs", [
    {"method": "column"},
    {"dtype": torch.float64},
    {"capacity": BIG_FILL_THRESHOLD + 1},
])
def test_collide_unported_paths_raise(kwargs):
    coords, radii = _scene(100, 0.05, 0)
    dtype = kwargs.get("dtype", torch.float32)
    with pytest.raises(NotImplementedError):
        collide(torch.from_numpy(coords).to(dtype), torch.from_numpy(radii).to(dtype),
                kwargs.get("capacity", 0), method=kwargs.get("method", "slab"))
