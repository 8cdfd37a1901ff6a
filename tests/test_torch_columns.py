"""Port parity: the column plan of collision_tpu_torch against the JAX
package's, on the same numpy scenes. Every ColumnPlan field the port
builds must be equal bit for bit (the stream compared as uint32 bit
patterns, so the id channel's denormals count too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import columns as jcolumns
from collision_tpu_torch import columns

PLAN_TENSORS = ("starts", "w0", "wcap", "ok", "max_col", "max_slab_rows",
                "rows_needed", "rows_rolled")
PLAN_INTS = ("n", "gxy", "mc", "slab_rows")


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
    elif kind == "wide":
        radii = rng.uniform(0, 0.12, n).astype("float32")
    return coords, radii


def _jax_fields(jp):
    return {k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in jp._asdict().items()}


def _both_plans(coords, radii, gxy=None):
    gxy, cap, rows = columns.default_column_config(len(coords), gxy=gxy)
    jp = jcolumns.plan_columns(jnp.asarray(coords), jnp.asarray(radii), gxy,
                               cap, rows)
    tp = columns.plan_columns(torch.from_numpy(coords),
                              torch.from_numpy(radii), gxy, cap, rows)
    return _jax_fields(jp), tp


def _assert_plans_equal(d, tp):
    np.testing.assert_array_equal(
        tp.stream.numpy().view(np.uint32), d["stream"].view(np.uint32))
    for name in PLAN_TENSORS:
        got = getattr(tp, name).numpy()
        assert got.dtype == d[name].dtype, name
        np.testing.assert_array_equal(got, d[name], err_msg=name)
    for name in PLAN_INTS:
        assert getattr(tp, name) == d[name], name


@pytest.mark.parametrize("kind,n,seed,gxy", [
    ("uniform", 2000, 0, None),
    ("clustered", 1500, 1, None),
    ("flat_z", 400, 2, None),      # zext == 0: the scale falls back to 1
    ("wide", 900, 17, 2),          # windows past 128 lanes
    ("uniform", 3000, 3, 16),      # zbits = 23: both divisions differ naively
])
def test_plan_fields_equal(kind, n, seed, gxy):
    coords, radii = _scene(kind, n, seed)
    d, tp = _both_plans(coords, radii, gxy)
    _assert_plans_equal(d, tp)


def test_default_column_config_matches_jax():
    for n in (1, 100, 4096, 32768, 262144, 1_000_000):
        assert columns.default_column_config(n) \
            == jcolumns.default_column_config(n)
        assert columns.default_column_config(n, gxy=16) \
            == jcolumns.default_column_config(n, gxy=16)
    for gxy in (1, 2, 13, 16, 26, 64, 256):
        assert columns._zbits(gxy) == jcolumns._zbits(gxy)


def test_z_divisions_are_ieee_at_gxy16():
    # zscale = zmax / zext and zext' = zmax / zscale. torch runs
    # ``int / tensor`` as ``reciprocal() * int``, two roundings, which at
    # zbits <= 24 (gxy >= 11: every default grid from 262144 spheres up)
    # disagrees with the JAX plan's division; the port divides two
    # float32 tensors instead.
    gxy = 16
    zbits = columns._zbits(gxy)
    assert zbits == 23
    zmax = (1 << zbits) - 1
    rng = np.random.RandomState(6)
    base = rng.random((64, 3)).astype("float32")
    naive_differs = [0, 0]
    for e in rng.uniform(0.1, 10.0, 300).astype("float32"):
        c = base.copy()
        c[0, 2], c[1, 2] = 0.0, e
        tc = torch.from_numpy(c)
        r = torch.full((64,), 0.001)
        zscale = columns._column_sort(tc, r, gxy)[5]
        jzscale = jcolumns._column_sort(jnp.asarray(c), jnp.asarray(r.numpy()),
                                        gxy).zscale
        assert zscale.numpy().view(np.uint32) \
            == np.asarray(jzscale).view(np.uint32)
        zext = columns._scalar(zmax, zscale) / zscale
        assert zext.numpy() == np.float32(zmax) / np.asarray(jzscale)
        naive_differs[0] += int(float(zmax / (tc.amax(0) - tc.amin(0))[2])
                                != float(zscale))
        naive_differs[1] += int(float(zmax / zscale) != float(zext))
    assert min(naive_differs) > 0   # both hazards are real at this gxy


def test_plan_from_numpy_roundtrip():
    coords, radii = _scene("uniform", 1000, 7)
    d, _ = _both_plans(coords, radii, gxy=3)
    _assert_plans_equal(d, columns.plan_from_numpy(d, "cpu"))


#: (kind, n, gxy) of the plan's edge scenes on the CPU: the kinds of
#: ``testing.scenes.column_plan_scene``; gxy None: the default config.
EDGE_PLANS = [("uniform", 1, None), ("uniform", 65, 14), ("dense", 3000, None),
              ("one_column", 300, 4), ("top_rounds_low", 2000, 1),
              ("parked", 129, 3), ("power_law", 2000, 64)]


@pytest.mark.parametrize("kind,n,gxy", EDGE_PLANS)
def test_plan_columns_on_cpu_is_the_plain_plan(kind, n, gxy):
    # On a CPU tensor plan_columns and the chain's wrapper both return the
    # plain path's plan (the plan the card's chain is held to,
    # tests/test_torch_cuda.py), which waits five times and launches
    # nothing; plan_columns counts its plan, the plain body does not.
    from collision_tpu_torch import tracing
    from collision_tpu_torch.kernels import column_plan
    from collision_tpu_torch.testing.scenes import (column_plan_scene,
                                                    plan_mismatches)

    coords, radii = column_plan_scene(kind, n, n + 7)
    c, r = torch.from_numpy(coords), torch.from_numpy(radii)
    config = columns.default_column_config(n, gxy=gxy)
    tracing.reset()
    want = columns.plan_columns_plain(c, r, *config)
    assert sum(tracing.HOST_SYNCS.values()) == 5 and not tracing.PLANS
    for by in ("engine", "retry"):
        tracing.reset()
        got = columns.plan_columns(c, r, *config, by=by)
        assert plan_mismatches(got, want) == []
        assert dict(tracing.HOST_SYNCS) == {"columns._scalar": 4,
                                            "columns.chunk_z_ranges": 1}
        assert dict(tracing.PLANS) == {by: 1}
    tracing.reset()
    assert plan_mismatches(column_plan.build_plan(c, r, *config), want) == []
    assert sum(tracing.HOST_SYNCS.values()) == 5 and not tracing.PLANS
    assert not any(tracing.LAUNCHES.values()), tracing.LAUNCHES


@pytest.mark.parametrize("n,gxy,col_capacity,slab_rows", [
    (0, 1, 64, 4), (100, 0, 64, 4), (100, -3, 64, 4), (100, 46341, 64, 4),
    (100, 2, 0, 4), (100, 2, -64, 4), (300, 2, 64, -4)])
def test_column_plan_rejects_bad_arguments(n, gxy, col_capacity, slab_rows):
    # The chain's wrapper checks its arguments on any device before any
    # launch, as kernels.slab_plan does on the card: no sphere, a gxy
    # whose extended column ids leave z no bit of a 32-bit key, no column
    # capacity, a stream shorter than the spheres.
    from collision_tpu_torch import tracing
    from collision_tpu_torch.kernels import column_plan

    tracing.reset()
    rng = np.random.RandomState(n)
    c = torch.from_numpy(rng.random((n, 3)).astype("float32"))
    r = torch.full((n,), 0.01)
    with pytest.raises(ValueError):
        column_plan.build_plan(c, r, gxy, col_capacity, slab_rows)
    assert not any(tracing.LAUNCHES.values())
    assert not tracing.HOST_SYNCS
