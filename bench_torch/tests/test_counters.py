"""The readers of the program's counters (``attempts_per_frame``,
``plans_per_frame``, ``host_syncs_per_frame``) on the CPU: on a small
stand-in of ``dense307k-pairs`` each reads its counter's total over the
frames the program ran, and each reads nothing where the program has no
such counter.

    python -m pytest -q bench_torch/tests
"""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import harness  # noqa: E402
import test_check  # noqa: E402

from collision_tpu_torch import tracing  # noqa: E402

READERS = {"attempts_per_frame.slab": "ATTEMPTS",
           "plans_per_frame.slab": "PLANS",
           "host_syncs_per_frame.slab": "HOST_SYNCS"}


def _read(name, ctx):
    return harness.load_module(harness.reader(name)).read(ctx)


def test_the_cell_lists_the_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metric_specs(
        bench, "dense307k-pairs", True)}
    assert set(READERS) <= names
    for cell in ("uniform16m-count", "uniform16m-pairs"):
        names = {m["name"] for m in harness.metric_specs(bench, cell, True)}
        assert "host_syncs_per_frame.slab" in names
        assert "plans_per_frame.slab" not in names


def test_readers_read_the_counters_on_the_dense_stand_in():
    tracing.reset()
    ctx, out = test_check.run("ref-dense-307k.pairs-all", traced=True)
    assert out["correct"], out["checks"]
    frames = ctx.traffic["frames"] + ctx.attempted
    # Every frame of the stand-in (3000 spheres, one column) fails at
    # the default two rows a window, and the retry's one statistics plan
    # sizes the column rung: two attempts and three plans a frame.
    assert dict(tracing.ATTEMPTS) == {"column": 2 * frames}
    assert dict(tracing.PLANS) == {"engine": 2 * frames, "retry": frames}
    for name, counter in READERS.items():
        total = sum(getattr(tracing, counter).values())
        assert _read(name, ctx) == total / frames
    assert _read("attempts_per_frame.slab", ctx) == 2
    assert _read("plans_per_frame.slab", ctx) == 3


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_without_the_counter(name, monkeypatch):
    tracing.reset()
    ctx, _ = test_check.run("ref-dense-307k.pairs-all")
    monkeypatch.delattr(tracing, READERS[name])
    assert _read(name, ctx) is None
    monkeypatch.delitem(sys.modules, "collision_tpu_torch.tracing")
    assert _read(name, ctx) is None
