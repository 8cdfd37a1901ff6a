"""The benchmark's core: one cell's set-up, measured window, the traced
run's profiled stretch, the check and the result line.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration (its file) and traffic mix (``traffic/<name>.json``); the
configuration names its plain reference (``references/<name>.py``); each
metric is computed by ``metrics/<name>.py``, whose ``read(ctx)`` returns
a number or None when it finds nothing to read. A metric named
``<name>.<group>`` is the same quantity in a group of cells, under a
bound or a ``moves`` of its own, and is read by ``metrics/<name>.py``.

A frame is one closed-loop call of the program's entry on the next of
the traffic's frames: the call, the count read back to the host, and a
synchronize. The answer is dropped before the next call.
"""

import importlib.util
import json
import random
import subprocess
import time
import types
from pathlib import Path

import torch

import digest
import entries
import scenes
import trace as tracing
import work

HERE = Path(__file__).resolve().parent

#: Each compared number's limit. Every one is exact: a count differs from
#: the reference's or it does not, a pair set is the reference's or not.
LIMITS = {"count_gap": 0, "not_ok": 0, "pair_sets_wrong": 0}


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + Path(path).stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench, name, root):
    """(workload, configuration, traffic) of the cell ``name``."""
    workload = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    return workload, config, traffic


def reader(metric):
    """The path of the reader of the metric named ``metric``."""
    return HERE / "metrics" / f"{metric.split('.')[0]}.py"


def metric_specs(bench, name, traced):
    """The metrics a run of cell ``name`` reports: the end-to-end ones,
    or with ``traced`` the per-layer ones, each kept where its
    ``workloads`` list it or, without the key, where the end-to-end
    metric it ``moves`` is reported."""
    def here(m):
        return name in m.get("workloads", [name])

    if not traced:
        return [m for m in bench["end_to_end"] if here(m)]
    e2e = {m["name"] for m in bench["end_to_end"] if here(m)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Frames:
    """The frame loop's records: for each frame run, where it ran
    (``w<k>``: the window's k-th frame; ``t<k>``: the traced stretch's),
    the frame index, its count and ok; and the pair buffers checked
    (where, frame index, count, (digest, bad rows, bad tail slots))."""

    def __init__(self):
        self.records = []
        self.pair_checks = []


def measure(config, traffic, seed, seconds, device, t_start, frame_fn=None,
            traced=False):
    """Set up, warm up, run the window and, when ``traced``, the
    profiled stretch; read the peak, free the program, and check.
    Returns the context the metric readers take. ``frame_fn`` replaces
    the program's entry (the control and the fault tests)."""
    scene = scenes.make_scene(config, traffic, seed, device)
    n, nf = scene.n, len(scene.frames)
    frame = frame_fn or entries.make(traffic, n, device)
    for f in range(nf):
        ans = frame(scene.frames[f], scene.radii)
        int(ans.count)
        _sync(device)
        del ans
    setup_s = time.perf_counter() - t_start

    rng = random.Random(int(seed))
    # The pair buffers checked: positions drawn from the seed among the
    # window's first ``checked_within`` frames, and the window's last.
    sample = set(rng.sample(range(traffic["checked_within"]),
                            traffic["checked_pair_frames"]))
    launches = entries.launch_counter()
    before = dict(launches)
    log = Frames()
    latencies, enqueue = [], []
    paused, k = 0.0, 0
    t0 = time.perf_counter()
    while True:
        f = k % nf
        t_call = time.perf_counter()
        ans = frame(scene.frames[f], scene.radii)
        t_ret = time.perf_counter()
        count = int(ans.count)
        _sync(device)
        t_done = time.perf_counter()
        latencies.append(t_done - t_call)
        enqueue.append(t_ret - t_call)
        log.records.append((f"w{k}", f, count, None if ans.ok is None
                            else bool(ans.ok)))
        k += 1
        last = t_done - t0 - paused >= seconds
        if last:
            window_s = t_done - t0 - paused
        if ans.pairs is not None and (k - 1 in sample or last):
            # Not timed: the window's clock stops while a buffer is read.
            log.pair_checks.append((f"w{k - 1}", f, count,
                                    digest.check_buffer(ans.pairs, count, n)))
            paused += time.perf_counter() - t_done
        del ans
        if last:
            break
    window_launches = {key: launches[key] - before[key] for key in launches}

    tr = profile(frame, scene, traffic, device, log, launches) \
        if traced else None

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    del frame
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed, faults = check(config, scene, log)
    return types.SimpleNamespace(
        config=config, traffic=traffic, n=n, device=device,
        setup_s=setup_s, latencies_s=latencies, enqueue_s=enqueue,
        window_s=window_s, frames=k, launches=window_launches,
        peak_bytes=peak, trace=tr, checks=checks, failed=failed,
        faults=faults,
        check_s=time.perf_counter() - t_check, attempted=len(log.records),
        pairs_checked=len(log.pair_checks))


def profile(frame, scene, traffic, device, log, launches):
    """The traced run's profiled stretch after the window: its
    ``traced_frames`` frames under ``torch.profiler``, each logged for
    the check. Returns the :class:`trace.Trace`."""
    kernels = tracing.kernel_pattern(
        tracing.load_kernel_names(HERE / "kernels.txt"))
    before = dict(launches)
    nf = len(scene.frames)

    def run(j, span):
        f = j % nf
        with span("bench.entry"):
            ans = frame(scene.frames[f], scene.radii)
        with span("bench.read_count"):
            count = int(ans.count)
        with span("bench.sync"):
            _sync(device)
        log.records.append((f"t{j}", f, count, None if ans.ok is None
                            else bool(ans.ok)))
        with span("bench.drop"):
            del ans

    tr = tracing.profile(run, traffic["traced_frames"], kernels)
    tr.launches = sum(launches[key] - before[key] for key in launches)
    return tr


def check(config, scene, log):
    """Compare every frame's count and ok, and each checked pair buffer,
    with the plain reference on the same frame. Returns ({name: value},
    the number of frames at fault, and a line for each)."""
    ref = load_module(HERE / "references" / f"{config['reference']}.py")
    dtype = scenes.DTYPES[config["dtype"]]
    n = scene.n
    with_pairs = {f for _, f, _, _ in log.pair_checks}
    ref_count, ref_digest = {}, {}
    for f in sorted({f for _, f, _, _ in log.records} | with_pairs):
        if f in with_pairs:
            total = dig = 0
            for a, b in ref.pairs(scene.frames[f], scene.radii, dtype):
                total += a.numel()
                dig += digest.key_sum(a, b, n)
            ref_count[f], ref_digest[f] = total, dig % digest.MOD
        else:
            ref_count[f] = ref.count(scene.frames[f], scene.radii, dtype)
    gaps = [abs(c - ref_count[f]) for _, f, c, _ in log.records]
    not_ok = [ok is False for _, _, _, ok in log.records]
    # A buffer that overflowed holds a prefix of the set, whose digest
    # is not the reference's: the traffic sizes its capacity above it.
    wrong_sets = [c != ref_count[f] or chk[0] != ref_digest[f]
                  or chk[1] > 0 or chk[2] > 0
                  for _, f, c, chk in log.pair_checks]
    faults = [f"{at} frame {f}: count {c}, reference {ref_count[f]}, ok {ok}"
              for (at, f, c, ok), g, bad in zip(log.records, gaps, not_ok)
              if g or bad]
    faults += [f"{at} frame {f}: pair buffer digest {chk[0]}, reference "
               f"{ref_digest[f]}, bad rows {chk[1]}, bad tail slots {chk[2]}"
               for (at, f, c, chk), w in zip(log.pair_checks, wrong_sets)
               if w]
    checks = {"count_gap": max(gaps)}
    if any(ok is not None for _, _, _, ok in log.records):
        checks["not_ok"] = sum(not_ok)
    if log.pair_checks:
        checks["pair_sets_wrong"] = sum(wrong_sets)
    failed = sum(g > 0 or bad for g, bad in zip(gaps, not_ok))
    return checks, failed + sum(wrong_sets), faults


def power_limit(device):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def result(bench, workload, ctx, traced):
    """The result line's object; ``checks`` comes last."""
    peaks = json.loads((HERE / "peaks.json").read_text())
    device = ctx.device
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx.peaks = peaks.get(kind)
    ctx.work = work
    metrics = {}
    for spec in metric_specs(bench, workload["name"], traced):
        value = load_module(reader(spec["name"])).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": workload["chips"],
           "memory_peak_bytes": ctx.peak_bytes}
    if device.type == "cuda":
        dev["power_limit"] = power_limit(device)
    out = {"correct": all(v <= LIMITS[k] for k, v in ctx.checks.items()),
           "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": [[k, v] for k, v in
                                           ctx.trace.top_ops()[:10]],
                            "idle_gaps": [[k, v] for k, v in
                                          ctx.trace.gap_labels()[:10]]}
    out["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                     for k, v in ctx.checks.items()}
    return out
