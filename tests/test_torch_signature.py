"""Port parity of the public signatures: ``collide`` takes the JAX
package's parameters, in its order and with its defaults, so that a call
written for the reference, knobs passed by position included, means the
same in the port; ``build_grid`` takes JAX's ``method`` keyword."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collision_tpu
from collision_tpu import grid as jgrid
from collision_tpu_torch import build_grid, collide

_EMPTY = inspect.Parameter.empty


def _plain(value):
    return value is None or isinstance(value, (bool, int, float, str))


@pytest.mark.parametrize("name", ["collide", "build_grid"])
def test_signature_matches_jax(name):
    want = inspect.signature(getattr(collision_tpu, name)).parameters
    got = inspect.signature(
        {"collide": collide, "build_grid": build_grid}[name]).parameters
    assert list(got) == list(want)
    for p in want:
        w, g = want[p].default, got[p].default
        assert (w is _EMPTY) == (g is _EMPTY), p
        if _plain(w) and _plain(g):
            assert w == g and type(w) is type(g), p


def _scene(n=1500, seed=6):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1.2 / np.sqrt(n), n).astype("float32")
    return coords, radii


@pytest.mark.parametrize("kernel_mode", [None, "native"])
def test_positional_knobs_match_jax(kernel_mode):
    # stack_depth and method by position: 64 lands on stack_depth in
    # both packages, "slab" on method.
    coords, radii = _scene()
    want = collision_tpu.collide(jnp.asarray(coords), jnp.asarray(radii), 0,
                                 64, "slab", kernel_mode=kernel_mode)
    got = collide(torch.from_numpy(coords), torch.from_numpy(radii), 0, 64,
                  "slab", kernel_mode=kernel_mode)
    assert bool(got.ok) == bool(want.ok) and bool(got.ok)
    assert int(got.count) == int(want.count) > 0


def test_kernel_mode_and_stack_depth():
    coords, radii = _scene(300)
    args = (torch.from_numpy(coords), torch.from_numpy(radii), 0)
    base = int(collide(*args, method="column").count)
    for mode in ("native", "interpret"):
        assert int(collide(*args, method="column",
                           kernel_mode=mode).count) == base
    assert int(collide(*args, 16, "column").count) == base
    with pytest.raises(ValueError, match="kernel_mode"):
        collide(*args, kernel_mode="mosaic")
    with pytest.raises(NotImplementedError):
        collide(*args, 64, "bvh")


@pytest.mark.parametrize("method", ["auto", "scatter", "compact"])
def test_build_grid_method_matches_jax(method):
    coords, radii = _scene(400, 3)
    jbins, jok, jids = jgrid.build_grid(jnp.asarray(coords),
                                        jnp.asarray(radii), 8, 32)
    bins, ok, ids = build_grid(torch.from_numpy(coords),
                               torch.from_numpy(radii), 8, 32, method=method)
    np.testing.assert_array_equal(bins.numpy().view(np.int32),
                                  np.asarray(jbins).view(np.int32))
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jids).astype(np.int64))
    with pytest.raises(ValueError, match="method"):
        build_grid(torch.from_numpy(coords), torch.from_numpy(radii), 8, 32,
                   method="gather")
