"""Check the benchmark's files on the CPU, without a card.

    python3 bench_torch/selfcheck.py

1. ``BENCHMARK.json`` keeps to the benchmark contract's shape: its keys,
   names, units, lengths, bounds and paths.
2. Every configuration, traffic mix, workload and metric loads by its
   name, and every metric reader under ``metrics/`` gives a number on a
   small synthetic trace and counter set.
3. No file of the harness imports JAX or the JAX package, or reads
   ``benchmarks/`` or ``bench.py``.
4. ``run.py`` given no card exits non-zero and prints no result.
5. A configuration, a traffic mix, a per-layer metric and a cell are
   added to a copy of the benchmark as new files and entries only, and
   a small run of the new cell on the CPU reports the new metric.

Prints one line a check and exits 1 if any fails.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import harness  # noqa: E402
import trace as tracing  # noqa: E402

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}

failures = []


def ok(cond, what):
    print(("ok   " if cond else "FAIL ") + what)
    if not cond:
        failures.append(what)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def check_shape(bench):
    ok(set(bench) == KEYS, "BENCHMARK.json has exactly the contract's keys")
    ok(1 <= len(bench["paths"]) <= 16
       and all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"]), "paths")
    cmd = bench["command"]
    ok(1 <= len(cmd) <= 32 and all(line(w) and not w.startswith("/")
                                   and ".." not in w for w in cmd),
       "command")
    ok(all(any(w == p or w.startswith(p + "/") for p in bench["paths"])
           for w in cmd if "/" in w), "command names files under paths only")
    ok(isinstance(bench["run_seconds"], int)
       and 1 <= bench["run_seconds"] <= 51, "run_seconds")
    for key, size in (("configs", 24), ("workloads", 24), ("end_to_end", 16),
                      ("per_layer", 128)):
        entries = bench[key]
        names = [e["name"] for e in entries]
        ok(1 <= len(entries) <= size and len(set(names)) == len(names),
           f"{key}: 1 to {size} entries, names unique")
        for e in entries:
            extra = set(e) - ENTRY_KEYS[key]
            ok(set(e) >= ENTRY_KEYS[key] and extra <= {"workloads"}
               and (not extra or key in ("end_to_end", "per_layer")),
               f"{key} {e['name']}: keys")
            ok(bool(NAME.fullmatch(e["name"])), f"{key} {e['name']}: name")
            if "unit" in e:
                ok(bool(UNIT.fullmatch(e["unit"])), f"{e['name']}: unit")
                ok(e["better"] in ("lower", "higher")
                   and e["source"] in SOURCES, f"{e['name']}: better, source")
    config_names = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    ok(used == config_names, "every configuration has a cell")
    for c in bench["configs"]:
        ok(line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
           and all(NAME.fullmatch(k) for k in c["reduced"])
           and any(c["file"].startswith(p + "/") for p in bench["paths"]),
           f"config {c['name']}: source, why, reduced, file under paths")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    ok(len(set(pairs)) == len(pairs), "a (config, traffic) pair appears once")
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    ok(all(w["chips"] in (1, 4) and line(w["why"])
           and NAME.fullmatch(w["traffic"]) for w in bench["workloads"])
       and fours <= max(1, len(bench["workloads"]) // 4),
       "workloads: chips, why, traffic names")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    ok("setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25, "setup_s")
    ok(all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
       and all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values()), "end-to-end bounds and sources")
    ok(all(m["moves"] in e2e and line(m["layer"])
           for m in bench["per_layer"]), "per-layer moves and layer")
    for m in bench["per_layer"]:
        for w in m.get("workloads", []):
            ok(w in {x["name"] for x in bench["workloads"]} and any(
                e["name"] == m["moves"] for e in
                harness.metric_specs(bench, w, False)),
               f"{m['name']}: cell {w} reports {m['moves']}")
    for w in bench["workloads"]:
        here = harness.metric_specs(bench, w["name"], False)
        layer = harness.metric_specs(bench, w["name"], True)
        ok(any(m["name"] == "setup_s" for m in here) and len(here) >= 2
           and layer, f"{w['name']} reports setup_s, another end-to-end "
           "metric and a per-layer one")
    ok(len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024,
       "BENCHMARK.json under 64 KiB")


def synthetic_trace(kernels):
    """Two frames of made-up events: per frame a kernel of the list, a
    sort and a memcpy on the device, and the harness's spans with one
    host op on the host."""
    ev = []
    for k in range(2):
        t = 1000.0 * k
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "bench.frame",
             "ts": t, "dur": 900.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": "bench.entry",
             "ts": t, "dur": 600.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cpu_op", "name": "aten::item",
             "ts": t + 100, "dur": 300.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
             "name": "void (anonymous namespace)::slab_count_kernel<true>"
                     "(float const*, int)", "ts": t + 50, "dur": 40.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
             "name": "void at::native::radixSortKVInPlace<float>(int)",
             "ts": t + 500, "dur": 100.0},
            {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
             "name": "Memcpy DtoH (Device -> Pageable)", "ts": t + 650,
             "dur": 10.0},
        ]
    return tracing.Trace(ev, 2, kernels)


def check_files(bench):
    kernels = tracing.kernel_pattern(
        tracing.load_kernel_names(HERE / "kernels.txt"))
    for w in bench["workloads"]:
        workload, config, traffic = harness.cell(bench, w["name"], ROOT)
        ok(config["name"] == w["config"] and traffic["name"] == w["traffic"]
           and (HERE / "references" / f"{config['reference']}.py").exists(),
           f"{w['name']}: configuration, traffic and reference load")
    import torch
    import scenes

    spec = {"dist": "pareto", "shape": 2.5, "offset": 0.2,
            "scale_sqrt_n": 1.0, "clip": 0.05}
    r = scenes.draw(spec, (100000,), 10 ** 6, torch.float32,
                    torch.Generator().manual_seed(1), "cpu")
    ok(float(r.min()) >= 0.199e-3 and float(r.max()) <= 0.0500001,
       "scenes: power-law radii within (0.2/sqrt(n), clip]")
    tr = synthetic_trace(kernels)
    tr.launches = 2
    ok(abs(tr.busy_s - 2 * 150e-6) < 1e-12, "trace: busy is the union")
    ok(tr.gap_labels()[0][0] == "entry: aten::item",
       "trace: idle gaps labelled by span and host op")
    ctx = types.SimpleNamespace(
        config={"dtype": "float32"}, traffic={"capacity": 16384}, n=1000,
        setup_s=3.0, latencies_s=[0.001 * (i + 1) for i in range(20)],
        enqueue_s=[0.0005] * 20, window_s=0.5, frames=20,
        launches={"slab_count": 20, "pair_emit": 0}, peak_bytes=10 ** 9,
        trace=tr, peaks={"hbm_bytes_per_s": 3.35e12},
        work=harness.work)
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    ok(all(harness.reader(n).exists() for n in named),
       "every metric of BENCHMARK.json has its reader")
    ok({harness.reader(n).stem for n in named}
       == {p.stem for p in (HERE / "metrics").glob("*.py")},
       "every reader under metrics/ reads a metric of BENCHMARK.json")
    for path in sorted((HERE / "metrics").glob("*.py")):
        value = harness.load_module(path).read(ctx)
        ok(isinstance(value, (int, float)) and math.isfinite(value),
           f"metric {path.stem}: reads {value}")
        if path.stem.endswith("_roofline") or "mfu" in path.stem:
            ok(0 < value <= 100, f"metric {path.stem}: a share in (0, 100]")
    ctx.trace = None
    ok(all(harness.load_module(harness.reader(m["name"]))
           .read(ctx) is None for m in bench["per_layer"]
           if m["source"] == "device_trace"),
       "device-trace readers return nothing without a trace")


def check_imports():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|collision_tpu\b(?!_torch)"
                     r"|benchmarks\b|bench\b)", re.M)
    reads = re.compile(r"[\"'](benchmarks/|bench\.py)")
    for path in sorted(HERE.rglob("*.py")):
        text = path.read_text()
        ok(not bad.search(text) and not reads.search(text),
           f"{path.relative_to(ROOT)}: no JAX, no benchmarks/ or bench.py")


def check_no_card(bench):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         bench["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=False)
    ok(proc.returncode != 0 and "{" not in proc.stdout,
       f"run.py without a card exits {proc.returncode}, prints no result")


def check_extension():
    """Add a cell with its own configuration, traffic and metric to a
    copy, by files and entries only, and run it small on the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copytree(HERE, root / "bench_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cfg = json.loads((HERE / "configs" / "uniform-1m.json").read_text())
        cfg.update(name="extra-uniform", n=50000)
        (root / "bench_torch/configs/extra-uniform.json").write_text(
            json.dumps(cfg))
        traffic = json.loads((HERE / "traffic/pairs-sparse.json").read_text())
        traffic.update(name="extra-mix", capacity=4096, frames=3,
                       checked_within=3, checked_pair_frames=1)
        (root / "bench_torch/traffic/extra-mix.json").write_text(
            json.dumps(traffic))
        (root / "bench_torch/metrics/extra_pairs_per_frame.py").write_text(
            "def read(ctx):\n    return ctx.attempted / ctx.frames\n")
        bench["configs"].append({
            "name": "extra-uniform", "source": "selfcheck",
            "file": "bench_torch/configs/extra-uniform.json", "reduced": [],
            "why": "selfcheck"})
        bench["workloads"].append({
            "name": "extra-cell", "config": "extra-uniform",
            "traffic": "extra-mix", "chips": 1, "why": "selfcheck"})
        for m in bench["end_to_end"]:
            if m["name"].endswith(".slab"):
                m["workloads"].append("extra-cell")
        bench["per_layer"].append({
            "name": "extra_pairs_per_frame", "unit": "frames",
            "better": "lower", "source": "program_counter", "layer": "device",
            "moves": "frame_ms.slab", "workloads": ["extra-cell"]})
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        code = (
            "import json, sys, time, torch\n"
            f"sys.path[:0] = ['{root}/bench_torch', '{ROOT}']\n"
            "import harness\n"
            "from pathlib import Path\n"
            f"root = Path('{root}')\n"
            "bench = json.loads((root / 'BENCHMARK.json').read_text())\n"
            "w, c, t = harness.cell(bench, 'extra-cell', root)\n"
            "ctx = harness.measure(c, t, 7, 0.2, torch.device('cpu'),"
            " time.perf_counter(), traced=True)\n"
            "print(json.dumps(harness.result(bench, w, ctx, True)))\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=600,
                              check=False)
        out = json.loads(proc.stdout.strip().splitlines()[-1]) \
            if proc.returncode == 0 else {}
        ok(out.get("correct") is True
           and "extra_pairs_per_frame" in out.get("metrics", {}),
           "a cell, configuration, traffic mix and metric added as files "
           "and entries run on the CPU" + ("" if out else ": "
                                           + proc.stderr[-500:]))


def main():
    t0 = time.perf_counter()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    check_shape(bench)
    check_files(bench)
    check_imports()
    check_no_card(bench)
    check_extension()
    print(f"{len(failures)} failed, {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
