"""The port's spans and counters (``collision_tpu_torch.tracing``) on the
CPU.

Without a profiler a span is one shared no-op and ``record_function``
is never called. Under ``torch.profiler`` every route opens its ``ct.*``
spans inside ``ct.collide``, each child inside its parent in time. The
host-sync counter counts, on any device, what each route waits for on
the card (held there by ``tests/test_torch_cuda.py`` under the sync
debug mode); the attempt counter counts one engine run a held frame and
more with a retry. No JAX: the port alone.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collision_tpu_torch import Collider, collide, tracing
from collision_tpu_torch import collider as collider_mod
from collision_tpu_torch.kernels import _build


def _uniform(n, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand(n, 3, generator=g, dtype=torch.float64).to(dtype)
    radii = (torch.rand(n, generator=g, dtype=torch.float64)
             / n ** 0.5).to(dtype)
    return coords, radii


def _power_law(n, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.35)
    return torch.from_numpy(coords), torch.from_numpy(radii.astype("float32"))


def _clustered(n, seed, r):
    # Every sphere inside one tiny xy patch: at gxy=2 one column holds
    # more than the default capacity, so the first column step fails.
    np.random.seed(seed)
    coords = np.random.random((n, 3)).astype(np.float32)
    coords[:, :2] *= 1e-3
    return coords, np.full(n, r, np.float32)


def _collide(scene, capacity, **kwargs):
    """A maker of one ``collide`` frame on the scene ``scene()``."""
    def make():
        args = scene()
        return lambda: collide(*args, capacity, **kwargs)
    return make


def _retry_frame():
    coords, radii = _clustered(4000, 13, 5e-4)
    c = Collider(4000, method="column", device="cpu")
    return lambda: c.get_collisions(coords, radii, 0, collisions=None)


def _held_frame():
    coords, radii = _uniform(3000)
    c = Collider(3000, device="cpu")
    return lambda: c.get_collisions(coords, radii, 1024)


SLAB = {("ct.collide", "ct.slab.plan"), ("ct.collide", "ct.slab.sweep"),
        ("ct.collide", "ct.slab.residual")}
COLUMN = {("ct.collide", "ct.column.plan"), ("ct.collide", "ct.column.sweep")}
HETERO = {("ct.collide", "ct.hetero.split"), ("ct.collide", "ct.hetero.big")}
GRID = {("ct.collide", "ct.grid.bins"), ("ct.collide", "ct.grid.counts")}

#: name: (the frame, its ct.* tree as (parent, child) edges, its host
#: syncs, its engine runs). A fill through the sparse emission waits
#: twice more than its count (``fill._mask_fill_emit``). A grid frame
#: waits for nothing: its bins are one kernel chain on the card.
ROUTES = {
    "slab_count": (_collide(lambda: _uniform(3000), 0, method="slab"),
                   SLAB, 6, {"slab": 1}),
    "slab_fill": (_collide(lambda: _uniform(3000), 1024, method="slab"),
                  SLAB | {("ct.collide", "ct.slab.emit")}, 8, {"slab": 1}),
    "grid_count": (_collide(lambda: _uniform(3000), 0, method="grid"),
                   GRID, 0, {"grid": 1}),
    "grid_fill": (_collide(lambda: _uniform(3000), 1024, method="grid"),
                  GRID | {("ct.collide", "ct.grid.emit")}, 0, {"grid": 1}),
    "column_count": (_collide(lambda: _uniform(3000), 0, method="column"),
                     COLUMN, 5, {"column": 1}),
    "column_fill": (_collide(lambda: _uniform(3000), 1024, method="column"),
                    COLUMN | {("ct.collide", "ct.column.emit")}, 7,
                    {"column": 1}),
    "hetero_count": (_collide(lambda: _power_law(1500), 0, method="hetero"),
                     HETERO | COLUMN | {("ct.collide", "ct.column.residual")},
                     6, {"hetero": 1}),
    "hetero_fill": (_collide(lambda: _power_law(1500), 4096, method="hetero"),
                    HETERO | COLUMN | {("ct.collide", "ct.column.emit")}, 8,
                    {"hetero": 1}),
    "hetero_slab_count": (_collide(lambda: _power_law(70000), 0,
                                   method="hetero"),
                          HETERO | SLAB, 7, {"hetero": 1}),
    "auto_slab_count": (_collide(lambda: _uniform(70000), 0),
                        SLAB | {("ct.collide", "ct.probe")}, 9, {"slab": 1}),
    "float64_runfill": (_collide(lambda: _uniform(2000, torch.float64), 512),
                        {("ct.collide", "ct.runfill")}, 5, {"runfill": 1}),
    "collider_held": (_held_frame,
                      {("ct.get_collisions", "ct.collide")}
                      | {("ct.collide", "ct.column.plan"),
                         ("ct.collide", "ct.column.sweep"),
                         ("ct.collide", "ct.column.emit")},
                      8, {"column": 1}),
}


def _ct_tree(prof):
    """(edges, roots): each ct.* event's innermost enclosing ct.* event
    by time, after checking that it lies inside it."""
    evs = sorted((e for e in prof.events() if e.name.startswith("ct.")),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    edges, roots, stack = set(), [], []
    for e in evs:
        while stack and stack[-1].time_range.end <= e.time_range.start:
            stack.pop()
        if stack:
            parent = stack[-1]
            assert parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= parent.time_range.end
            edges.add((parent.name, e.name))
        else:
            roots.append(e.name)
        stack.append(e)
    return edges, roots


def test_launches_is_the_tracing_counter():
    assert _build.LAUNCHES is tracing.LAUNCHES
    assert not hasattr(_build, "reset_launches")


def test_span_is_a_shared_noop_without_profiler(monkeypatch):
    assert tracing.span("ct.a") is tracing.span("ct.b")
    with tracing.span("ct.a") as inside:
        assert inside is None

    def boom(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    res = collide(*_uniform(3000), 1024, method="slab")
    assert bool(res.ok)


@pytest.mark.parametrize("name", list(ROUTES))
def test_span_tree(name):
    run = ROUTES[name][0]()
    run()   # warm: nothing of a first call's set-up inside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    edges, roots = _ct_tree(prof)
    assert edges == ROUTES[name][1]
    assert roots == (["ct.get_collisions"] if name.startswith("collider")
                     else ["ct.collide"])


def test_span_tree_with_retry():
    run = _retry_frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    edges, roots = _ct_tree(prof)
    assert roots == ["ct.get_collisions"]
    assert {("ct.get_collisions", "ct.collide"),
            ("ct.get_collisions", "ct.retry"),
            ("ct.retry", "ct.column.plan"),
            ("ct.retry", "ct.collide"),
            ("ct.collide", "ct.column.plan"),
            ("ct.collide", "ct.column.sweep")} <= edges
    assert {p for p, _ in edges} <= {"ct.get_collisions", "ct.retry",
                                     "ct.collide"}


@pytest.mark.parametrize("name", list(ROUTES) + ["collider_retry"])
def test_counters(name):
    run = (_retry_frame if name == "collider_retry" else ROUTES[name][0])()
    run()
    tracing.reset()
    run()
    attempts = dict(tracing.ATTEMPTS)
    syncs = sum(tracing.HOST_SYNCS.values())
    # A CPU frame takes every kernel's plain version: the grid frame
    # builds its bins by grid.build_grid_plain, not the kernel chain.
    assert not any(tracing.LAUNCHES.values()), tracing.LAUNCHES
    if name == "collider_retry":
        assert attempts["column"] >= 2
        assert tracing.HOST_SYNCS["collider._retry_exact"] >= 4
        return
    assert attempts == ROUTES[name][3]
    assert syncs == ROUTES[name][2], dict(tracing.HOST_SYNCS)


def test_retry_counts_the_hetero_slab_rung(monkeypatch):
    # Uniform small spheres and 64 of radius 0.05: the slab engine's
    # first attempt fails, so the ladder runs the hetero engine's slab
    # S-S pass directly, not through collide. Each run is one attempt
    # and one ct.collide rung.
    coords, radii = _uniform(70000)
    radii[:64] = 0.05
    c = Collider(70000, method="slab", device="cpu")
    runs = []
    real = collider_mod.hetero_collide

    def counted(*args, **kwargs):
        runs.append(kwargs.get("engine", "column"))
        return real(*args, **kwargs)

    monkeypatch.setattr(collider_mod, "hetero_collide", counted)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.get_collisions(coords, radii, 0, collisions=None)
    assert runs and runs[0] == "slab"
    assert dict(tracing.ATTEMPTS) == {"slab": 1, "hetero": len(runs)}
    rungs = [e for e in prof.events() if e.name == "ct.collide"]
    assert len(rungs) == 1 + len(runs)
    edges, roots = _ct_tree(prof)
    assert roots == ["ct.get_collisions"]
    assert {("ct.get_collisions", "ct.collide"),
            ("ct.get_collisions", "ct.retry"), ("ct.retry", "ct.collide"),
            ("ct.collide", "ct.hetero.split"),
            ("ct.collide", "ct.slab.plan")} <= edges


def test_reset_keeps_the_launch_keys():
    keys = set(tracing.LAUNCHES)
    tracing.LAUNCHES["slab_count"] += 3
    tracing.HOST_SYNCS["x"] += 1
    tracing.ATTEMPTS["slab"] += 1
    tracing.reset()
    assert set(tracing.LAUNCHES) == keys
    assert not any(tracing.LAUNCHES.values())
    assert not tracing.HOST_SYNCS and not tracing.ATTEMPTS
