"""Port parity: the slab plan and the residual jobs of collision_tpu_torch
against the JAX package's, on the same numpy scenes. Every shared
SlabPlan field must be equal bit for bit (the stream compared as uint32
bit patterns, so the id channel's denormals count too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import slabs as jslabs
from collision_tpu_torch import slabs
from collision_tpu_torch.kernels import slab_plan
from collision_tpu_torch.testing.scenes import (SLAB_PLAN_KINDS,
                                                plan_mismatches,
                                                slab_plan_scene)

PLAN_TENSORS = ("starts", "w0", "wcap", "ok", "max_col", "max_slab_rows",
                "rows_rolled")
PLAN_INTS = ("n", "gx", "mc", "slab_rows")


def _scene(kind, n, seed):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1 / np.sqrt(n), n).astype("float32")
    if kind == "clustered":
        centers = rng.random((6, 3))
        coords = (centers[rng.randint(0, 6, n)]
                  + 0.03 * rng.standard_normal((n, 3))).astype("float32")
    elif kind == "flat_z":
        coords[:, 2] = 0.5
        radii = np.full(n, 0.003, dtype="float32")
    return coords, radii


def _both_plans(coords, radii, gx=None):
    gx, cap, rows = slabs.default_slab_config(len(coords), gx=gx)
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), gx, cap, rows)
    tp = slabs.plan_slabs(torch.from_numpy(coords), torch.from_numpy(radii),
                          gx, cap, rows)
    return jp, tp


def _jax_fields(jp):
    return {k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in jp._asdict().items()}


def _assert_plans_equal(d, tp):
    np.testing.assert_array_equal(
        tp.stream.numpy().view(np.uint32), d["stream"].view(np.uint32))
    for name in PLAN_TENSORS:
        got = getattr(tp, name).numpy()
        assert got.dtype == d[name].dtype, name
        np.testing.assert_array_equal(got, d[name], err_msg=name)
    for name in PLAN_INTS:
        assert getattr(tp, name) == d[name], name


@pytest.mark.parametrize("kind,n,seed,gx", [
    ("uniform", 2000, 0, None),
    ("clustered", 1500, 1, None),
    ("flat_z", 400, 2, None),      # zext == 0: the scale falls back to 1
    ("uniform", 3000, 3, 300),     # zbits = 23: f32(zmax) is exact
])
def test_plan_fields_equal(kind, n, seed, gx):
    coords, radii = _scene(kind, n, seed)
    jp, tp = _both_plans(coords, radii, gx)
    _assert_plans_equal(_jax_fields(jp), tp)


def test_zscale_is_ieee_division_at_gx300():
    # zscale = zmax / zext. torch runs ``int / tensor`` as
    # ``reciprocal() * int``, two roundings, which at zbits <= 24 (gx >=
    # 255) disagrees with the JAX plan's division on about a quarter of
    # the extents; the port divides two float32 tensors instead.
    gx = 300
    zbits = slabs._xbits_z(gx)
    assert zbits == 23
    zmax = (1 << zbits) - 1
    rng = np.random.RandomState(6)
    coords = rng.random((400, 3)).astype("float32")
    ext = rng.uniform(0.1, 10.0, 400).astype("float32")
    coords[:, 0] = np.linspace(0, 1, 400)
    naive_differs = 0
    for e in ext:
        c = coords.copy()
        c[0, 2], c[1, 2] = 0.0, e
        lo, hi = torch.from_numpy(c).amin(0), torch.from_numpy(c).amax(0)
        r_max = torch.tensor(np.float32(0.001))
        _, zscale, _ = slabs.slab_sort_keys(torch.from_numpy(c), gx, lo, hi - lo, r_max)
        jl, jh = jnp.min(jnp.asarray(c), 0), jnp.max(jnp.asarray(c), 0)
        _, jz = jslabs.slab_sort_keys(jnp.asarray(c), None, gx, jl, jh - jl,
                                      jnp.float32(0.001))
        assert zscale.numpy().view(np.uint32) == np.asarray(jz).view(np.uint32)
        naive_differs += int((zmax / (hi - lo)[2]).item() != float(zscale))
    assert naive_differs > 0   # the hazard is real at this gx


def test_plan_from_numpy_roundtrip():
    coords, radii = _scene("uniform", 1000, 7)
    jp, tp = _both_plans(coords, radii)
    d = _jax_fields(jp)
    _assert_plans_equal(d, slabs.plan_from_numpy(d, "cpu"))


def _residual_scene(n, rmax, seed, gx, cap, rows):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rmax, n).astype("float32")
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), gx, cap, rows)
    return jp, slabs.plan_from_numpy(_jax_fields(jp), "cpu")


@pytest.mark.parametrize("scene,j_cap,ok", [
    ((900, 0.05, 17, 2, 512, 8), 256, True),     # windows up to ~179 lanes
    ((1200, 0.25, 19, 1, 1216, 12), 512, True),  # windows past 256 lanes
    ((1200, 0.25, 19, 1, 1216, 12), 4, False),   # job list overflows
])
def test_residual_count(scene, j_cap, ok):
    jp, tp = _residual_scene(*scene)
    assert int(jp.rows_rolled) >= 2   # residual jobs actually exist
    jc, jok = jslabs.residual_count(jp, j_cap)
    tc, tok = slabs.residual_count(tp, j_cap)
    assert bool(tok) == bool(jok) == ok
    assert int(tc) == int(jc)


@pytest.mark.parametrize("p_cap", [4096, 300])   # the scene has 461
def test_residual_pairs(p_cap):
    jp, tp = _residual_scene(900, 0.12, 17, 2, 512, 8)
    ja, jb, jc, jok = jslabs.residual_pairs(jp, p_cap=p_cap, interpret=True)
    ta, tb, tc, tok = slabs.residual_pairs(tp, p_cap=p_cap)
    assert int(tc) == int(jc) and bool(tok) == bool(jok)
    assert bool(tok) == (p_cap == 4096)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))


#: (kind, n, gx) of the plan's edge scenes; gx None: the default config.
EDGE_PLANS = [(kind, n, gx) for kind in SLAB_PLAN_KINDS
              for n, gx in ((2, 1), (63, 7), (129, None))] + [
    ("uniform", 64, 4096), ("ties", 3000, 7), ("giant", 1000, None)]


@pytest.mark.parametrize("kind,n,gx", EDGE_PLANS)
def test_build_plan_on_cpu_is_the_plain_plan(kind, n, gx):
    # On a CPU tensor the chain's wrapper and plan_slabs both return the
    # plain path's plan, the plan the card's chain is held to
    # (tests/test_torch_cuda.py); that plan is the JAX package's.
    coords, radii = slab_plan_scene(kind, n, n + 5)
    config = slabs.default_slab_config(n, gx=gx)
    c, r = torch.from_numpy(coords), torch.from_numpy(radii)
    want = slabs.plan_slabs_plain(c, r, *config)
    for got in (slab_plan.build_plan(c, r, *config),
                slabs.plan_slabs(c, r, *config)):
        assert plan_mismatches(got, want) == []
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), *config)
    d = _jax_fields(jp)
    _assert_plans_equal(d, want)
    np.testing.assert_array_equal(want.diag_thr.numpy().view(np.uint32),
                                  d["diag_thr"].view(np.uint32))
    if kind == "giant":
        assert int(want.max_col) == n   # every sphere in slab 0


def test_plan_slabs_on_cpu_launches_nothing():
    from collision_tpu_torch import tracing

    coords, radii = slab_plan_scene("uniform", 2000, 3)
    tracing.reset()
    slabs.plan_slabs(torch.from_numpy(coords), torch.from_numpy(radii),
                     *slabs.default_slab_config(2000))
    assert not any(tracing.LAUNCHES.values()), tracing.LAUNCHES
    assert sum(tracing.HOST_SYNCS.values()) == 6
