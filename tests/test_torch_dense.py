"""The reference benchmark's dense scene, cut to a few thousand spheres,
through ``Collider.get_collisions`` on the CPU; and the column and slab
plans' scene-top clamp.

The dense scene (kwohlfahrt/collision ``tests/benchmarks/
test_collide.py``: centers U(0,1)^3, radii U(0, r_max)) is held to the
plain reference of the benchmark (``bench_torch/references/
box_overlap.py``, loaded by path) and to a brute-force count, and the
frame's counters are pinned: the route a frame of the full scene takes
on the card, where the benchmark reads them. No JAX: the port alone.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collision_tpu_torch import Collider, collide, fill, tracing
from collision_tpu_torch import collider as collider_mod
from collision_tpu_torch.testing import (brute_force_collisions,
                                         pair_array_to_set)
from collision_tpu_torch.testing.scenes import scene_top_rounds_low

REFERENCE = (Path(__file__).resolve().parents[1] / "bench_torch"
             / "references" / "box_overlap.py")


def _reference():
    spec = importlib.util.spec_from_file_location("box_overlap", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dense(seed, n=3400, r_max=0.3):
    """The dense scene at n spheres, radii scaled to ~570 box contacts a
    sphere (the full scene's 307,200 keep ~700). As there, 2 r_max is
    wider than 1/gxy, so the columns overflow the default capacity."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 3, generator=g),
            torch.rand(n, generator=g) * r_max)


def _plans_by_parent(prof):
    """{parent span: ct.column.plan spans directly inside it}."""
    evs = sorted((e for e in prof.events() if e.name.startswith("ct.")),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    out, stack = {}, []
    for e in evs:
        while stack and stack[-1].time_range.end <= e.time_range.start:
            stack.pop()
        if e.name == "ct.column.plan":
            out[stack[-1].name] = out.get(stack[-1].name, 0) + 1
        stack.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_collider_matches_reference(seed, monkeypatch):
    coords, radii = _dense(seed)
    n = coords.shape[0]
    # The full scene's route: auto probes the radius spread, as at n >=
    # HETERO_AUTO_MIN, and fills above the threshold, as at 110,000,000,
    # so the emission takes the pair-emission kernel's route.
    monkeypatch.setattr(collider_mod, "HETERO_AUTO_MIN", 0)
    capacity = fill.BIG_FILL_THRESHOLD + 1
    c = Collider(n, device="cpu")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        count, pairs = c.get_collisions(coords, radii, capacity)
    # auto finds the scene uniform and fills on the column route at rpw
    # 2, which fails; the retry plans for its statistics, finds the
    # column capacity short, plans again and runs the column rung at its
    # rows-per-window rung.
    assert dict(tracing.ATTEMPTS) == {"column": 2}
    assert dict(tracing.PLANS) == {"engine": 2, "retry": 2}
    assert tracing.HOST_SYNCS["collider._route_hetero_eager"] == 1
    assert sum(tracing.HOST_SYNCS.values()) == 36, dict(tracing.HOST_SYNCS)
    assert _plans_by_parent(prof) == {"ct.collide": 2, "ct.retry": 2}

    ref = _reference()
    want = set()
    for a, b in ref.pairs(coords, radii, torch.float32):
        want |= {(min(x, y), max(x, y))
                 for x, y in zip(a.tolist(), b.tolist())}
    assert len(want) == ref.count(coords, radii, torch.float32)
    assert 2 * len(want) / n > 500
    assert want == brute_force_collisions(coords.numpy(), radii.numpy())
    assert int(count) == len(want)
    assert pair_array_to_set(pairs, count) == want
    assert bool((pairs[int(count):] == fill.NO_PAIR).all())


@pytest.mark.parametrize("method,capacity", [("column", 4096), ("column", 0),
                                             ("slab", 4096), (None, 4096)])
def test_topmost_sphere_keeps_its_pairs(method, capacity):
    # The topmost sphere (id 1) is in every window that reaches the top
    # of the scene, where lo + zext rounds below it. No method: the
    # Collider's frame.
    coords, radii = scene_top_rounds_low()
    want = brute_force_collisions(coords, radii)
    assert sum(1 in p for p in want) == 10
    c, r = torch.from_numpy(coords), torch.from_numpy(radii)
    if method is None:
        count, pairs = Collider(len(c), device="cpu").get_collisions(
            c, r, capacity)
    else:
        res = collide(c, r, capacity, method=method)
        assert bool(res.ok)
        count, pairs = res.count, res.pairs
    assert int(count) == len(want)
    if pairs is not None:
        assert pair_array_to_set(pairs, count) == want


def test_topmost_sphere_lies_above_the_rounded_top():
    # The scene does what it is for: the column plan's scene top, lo +
    # zmax / zscale in float32, lands a quantum below the topmost sphere.
    from collision_tpu_torch.columns import _quantize, _zbits

    coords, _ = scene_top_rounds_low()
    z = torch.from_numpy(coords[:, 2])
    lo, hi = z.min(), z.max()
    zmax = (1 << _zbits(1)) - 1
    zscale = torch.tensor(float(zmax)) / (hi - lo)
    zext = torch.tensor(float(zmax)) / zscale
    assert float(lo + zext) < float(hi)
    assert int(_quantize(lo + zext, lo, zscale, zmax)) \
        < int(_quantize(hi, lo, zscale, zmax))
    assert float(hi) == np.float32(0.8492043614387512)
