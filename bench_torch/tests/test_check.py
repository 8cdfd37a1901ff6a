"""The check that decides ``correct``, on the CPU at a small size.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, window, check, result line) through ``harness.measure`` and
``harness.result``, with the port's plain CPU path as the program. A
sound run must come out correct; the control (the plain reference in the
precision below the scene's) and each fault a cell can have must come
out not correct:

- ``stale``: a frame returns the previous frame's answer, as a step that
  leaves its state unchanged would;
- ``half``: a frame answers for the first half of the spheres only;
- ``altered``: the answer is changed where it is produced: the count
  plus one, and one pair's second id moved to another sphere.

A one-card cell has no exchange between cards to leave out.

    python -m pytest -q bench_torch/tests
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import control  # noqa: E402
import entries  # noqa: E402
import harness  # noqa: E402

CPU = torch.device("cpu")

#: Small stand-ins of each (configuration, traffic) file pair: the
#: configuration at n spheres, the traffic with four frames and, for
#: fills, a capacity the scene fits. A pinned slab grid is scaled with
#: the scene: 1000 slabs are twice the default of 16M spheres, 56 twice
#: that of 50,000.
SMALL = {("ref-dense-307k", "pairs-all"): (3000, 20000),
         ("ref-dense-307k", "count"): (3000, 0),
         ("uniform-1m", "count-auto"): (50000, 0),
         ("uniform-1m", "pairs-sparse"): (50000, 4096),
         ("uniform-16m", "count-slab-gx1000"): (50000, 0, {"gx": 56}),
         ("uniform-16m", "pairs-slab-gx1000"): (50000, 4096, {"gx": 56}),
         ("uniform-16m", "pairs-grid"): (50000, 4096)}
NAMES = [f"{c}.{t}" for c, t in SMALL]


def group(name):
    """The group of cells whose frame metrics a stand-in reports."""
    return "grid" if name.endswith("-grid") else "slab"


def small_cell(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    c, t = name.split(".")
    config = json.loads((HERE / "configs" / f"{c}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{t}.json").read_text())
    n, capacity, *knobs = SMALL[c, t]
    workload = {"name": name, "config": c, "traffic": t, "chips": 1}
    bench["workloads"].append(workload)
    for m in bench["end_to_end"]:
        if m["name"].endswith("." + group(name)):
            m["workloads"].append(name)
    kwargs = dict(traffic["kwargs"], **(knobs[0] if knobs else {}))
    return (bench, workload, dict(config, n=n),
            dict(traffic, capacity=capacity, kwargs=kwargs, frames=4,
                 checked_within=4, checked_pair_frames=2, traced_frames=2))


def stale(frame):
    last = []

    def broken(coords, radii):
        ans = frame(coords, radii)
        last.append(ans)
        return last.pop(0) if len(last) > 1 else ans
    return broken


def half(traffic, n):
    frame = entries.make(traffic, n // 2, CPU)
    return lambda coords, radii: frame(coords[:n // 2], radii[:n // 2])


def altered(frame):
    def broken(coords, radii):
        ans = frame(coords, radii)
        if ans.pairs is not None:
            pairs = ans.pairs.clone()
            pairs[0, 1] = (pairs[0, 1] + 1) % coords.shape[0]
            return ans._replace(pairs=pairs)
        return ans._replace(count=ans.count + 1)
    return broken


def run(name, make_frame=None, traced=False, seed=2**31 + 11):
    bench, workload, config, traffic = small_cell(name)
    fn = make_frame(config, traffic) if make_frame else None
    ctx = harness.measure(config, traffic, seed, 0.3, CPU,
                          time.perf_counter(), frame_fn=fn, traced=traced)
    return ctx, harness.result(bench, workload, ctx, traced)


@pytest.mark.parametrize("name", NAMES)
def test_sound_run_is_correct(name):
    ctx, out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"setup_s", f"frame_ms.{group(name)}"} <= set(out["metrics"])
    if SMALL[tuple(name.split("."))][1] > 0:
        assert ctx.pairs_checked >= 1


@pytest.mark.parametrize("name", NAMES)
def test_traced_run_is_correct(name):
    ctx, out = run(name, traced=True)
    assert out["correct"], out["checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert f"launches_per_frame.{group(name)}" in out["metrics"]


@pytest.mark.parametrize("name", NAMES)
def test_control_is_not_correct(name):
    def make(config, traffic):
        return control.control_frame(config, traffic, CPU)
    ctx, out = run(name, make)
    assert not out["correct"], out["checks"]
    assert out["checks"]["count_gap"]["value"] > 0


FAULTS = {
    "stale": lambda config, traffic: stale(
        entries.make(traffic, config["n"], CPU)),
    "half": lambda config, traffic: half(traffic, config["n"]),
    "altered": lambda config, traffic: altered(
        entries.make(traffic, config["n"], CPU)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", NAMES)
def test_fault_is_not_correct(name, fault):
    ctx, out = run(name, FAULTS[fault])
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
