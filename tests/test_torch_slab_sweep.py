"""Port parity: the three kernels' plain versions against the JAX Pallas
kernels (in interpret mode), on one plan carried across with
``plan_from_numpy``. Integer outputs: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import slabs as jslabs
from collision_tpu.kernels import compact as jcompact
from collision_tpu.kernels import slab_sweep as jsweep
from collision_tpu_torch import slabs
from collision_tpu_torch.kernels import compact, slab_sweep
from collision_tpu_torch.testing import brute_force_collisions
from collision_tpu_torch.testing.scenes import SLAB_EDGES, SLAB_SCENES, slab_edges

SCENES = [
    # n, r_max, seed, gx (None: default config)
    (2000, 1 / np.sqrt(2000), 0, None),
    (1000, 2 / np.sqrt(1000), 1, 5),
    (900, 0.12, 17, 2),     # windows past 128 lanes: residual jobs
]


def _plans(n, r_max, seed, gx):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, r_max, n).astype("float32")
    return (coords, radii) + _plans_of(coords, radii, gx)


def _plans_of(coords, radii, gx, cap=None):
    """(JAX plan, the port's plan from its fields)."""
    gx, default_cap, rows = slabs.default_slab_config(len(coords), gx=gx)
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), gx,
                           cap or default_cap, rows)
    d = {k: np.asarray(v) if hasattr(v, "shape") else v
         for k, v in jp._asdict().items()}
    return jp, slabs.plan_from_numpy(d, "cpu")


@pytest.mark.parametrize("scene", SCENES)
def test_slab_count_dual_plain_matches_pallas(scene):
    coords, radii, jp, tp = _plans(*scene)
    jc, jok = jsweep.slab_count_dual(jp, interpret=True)
    tc, tok = slab_sweep.slab_count_dual(tp)
    assert bool(tok) == bool(jok) and bool(tok)
    assert int(tc) == int(jc) == len(brute_force_collisions(coords, radii))


@pytest.mark.parametrize("scene", SCENES)
def test_slab_masks_plain_matches_pallas(scene):
    _, _, jp, tp = _plans(*scene)
    clamped = jp._replace(wcap=jnp.minimum(jp.wcap, 128))
    want = np.asarray(jsweep.slab_sweep_masks(clamped, rpw=1, interpret=True))
    got = slab_sweep.slab_sweep_masks(tp)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("name", sorted(SLAB_SCENES))
def test_slab_plain_matches_pallas_on_cull_edges(name):
    # The card kernels' cull at its edges (testing/scenes.py): each scene
    # reaches its edge; the count at two rolled rows, the cross-only pass
    # of slab_count_diag (offset x+1, j > i + 48) and the masks at two
    # rows, held to the JAX kernels.
    jp, tp = _plans_of(*SLAB_SCENES[name]())
    assert bool(tp.ok)
    assert SLAB_EDGES[name] <= slab_edges(
        *(t.numpy() for t in (tp.stream, tp.starts, tp.w0, tp.wcap)), tp.gx)
    args = (tp.stream, tp.starts, tp.w0, tp.wcap)
    for rpw, offsets, dmin in ((2, (0, 1), 0), (1, (1,), 48)):
        want, _ = jsweep._slab_count(
            jp.stream, jp.starts, jp.slab_r0, jp.w0, jp.wcap, jp.gx, jp.mc,
            jp.slab_rows, rpw, True, 1, offsets, dmin)
        got = slab_sweep.slab_window_count_plain(*args, rpw=rpw,
                                                 first_off=offsets[0],
                                                 dmin=dmin)
        assert int(got) == int(want)
    want = np.asarray(jsweep.slab_sweep_masks(jp, rpw=2, interpret=True))
    got = slab_sweep.slab_masks_plain(*args, rpw=2)
    assert int((got != 0).sum()) > 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n,density,capacity", [
    (5, 0.0, 8),            # nothing set
    (1000, 0.03, 8),        # capacity < total: truncated, true total
    (70001, 0.001, 100),    # more than one TPU block, ragged end
    (3000, 0.5, 4096),      # capacity > total: sentinel tail
])
def test_compact_plain_matches_pallas(n, density, capacity):
    rng = np.random.RandomState(n)
    mask = rng.random(n) < density
    want_idx, want_total = jcompact.compact_mask(
        jnp.asarray(mask), capacity, interpret=True)
    idx, total = compact.compact_mask(torch.from_numpy(mask), capacity)
    assert int(total) == int(want_total) == int(mask.sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx).astype(np.int64))


def _edge_mask(n, pattern):
    """A bool mask of n elements: all set, none, only the last, or 30%."""
    if pattern == "random":
        return np.random.RandomState(n).random(n) < 0.3
    mask = np.full(n, pattern == "all")
    mask[-1] = pattern != "none"
    return mask


@pytest.mark.parametrize("pattern", ["all", "none", "last", "random"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 1])
def test_compact_plain_edges_match_pallas(n, pattern):
    # The card kernel's tile edges (4096 elements); one JAX run with room
    # for every index, the port's cuts below, at and above the total held
    # to its prefix. The contract: int64 indices, ascending, 0xFFFFFFFF
    # past the total, the true total as an int64 0-dim tensor.
    mask = _edge_mask(n, pattern)
    total = int(mask.sum())
    want_idx, want_total = jcompact.compact_mask(
        jnp.asarray(mask), total + 5, interpret=True)
    want_idx = np.asarray(want_idx).astype(np.int64)
    assert int(want_total) == total
    for capacity in sorted({0, 1, max(total - 1, 0), total, total + 5}):
        idx, got_total = compact.compact_mask(torch.from_numpy(mask), capacity)
        assert idx.dtype == got_total.dtype == torch.int64
        assert idx.shape == (capacity,) and got_total.dim() == 0
        assert int(got_total) == total
        kept = min(capacity, total)
        np.testing.assert_array_equal(idx[:kept].numpy(), want_idx[:kept])
        assert bool((idx[kept:] == compact.NO_INDEX).all())
        assert (np.diff(idx[:kept].numpy()) > 0).all()


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.float32])
def test_compact_takes_only_bool_masks(dtype):
    with pytest.raises(ValueError, match="bool mask"):
        compact.compact_mask(torch.ones(10, dtype=dtype), 4)
