"""Smoke run of collision_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from collision_tpu_torch/csrc, drives the port's
main path through ``collide`` (a count-only step and a 16384-capacity
fill on 1M uniform spheres from seed 4, radii U(0, 1/sqrt(n)), as in
bench.py) with the kernel launch counters reset just before, checks both
against an independent k-d tree oracle and against the same pipeline run
with every kernel's plain PyTorch version, repeats the check at a pinned
gx=300, compares each kernel with its plain version at the main path's
shapes, and times them with CUDA events: the steps one call at a time
(closed loop), each kernel and its plain version over back-to-back calls.

Prints one line per phase; the line before the last is the per-kernel
JSON record and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no such line, when there is no CUDA device or
any check fails.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N = 1_000_000
SEED = 4
CAPACITY = 16384
PINNED_GX = 300
#: Back-to-back calls per timing sample of a kernel and its plain version.
KERNEL_BATCH = 20

FAILURES = []


def check(cond, what):
    print(("ok   " if cond else "FAIL ") + what, flush=True)
    if not cond:
        FAILURES.append(what)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def time_ms(fn, warmup=2, reps=10, batch=1):
    """Median milliseconds per call of ``fn`` on the current stream, by
    CUDA events: each of ``reps`` samples times ``batch`` calls in a row.

    ``batch=1`` is a closed loop, the host's enqueue included, as a
    simulation frame sees it. With a larger batch the launches queue
    behind one another, so a call that takes longer on the device than
    on the host is timed by its device time.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Run the pipeline with each kernel's plain version, on the card."""
    from collision_tpu_torch.kernels import compact, slab_sweep

    saved = slab_sweep.slab_count, slab_sweep.slab_masks, compact.compact_mask
    slab_sweep.slab_count = slab_sweep.slab_count_plain
    slab_sweep.slab_masks = slab_sweep.slab_masks_plain
    compact.compact_mask = compact.compact_mask_plain
    try:
        yield
    finally:
        slab_sweep.slab_count, slab_sweep.slab_masks, compact.compact_mask = saved


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_against_oracle(res_count, res_fill, expected, label):
    check(bool(res_count.ok), f"{label}: count ok")
    check(int(res_count.count) == len(expected),
          f"{label}: count {int(res_count.count)} == oracle {len(expected)}")
    check(bool(res_fill.ok), f"{label}: fill ok")
    check(int(res_fill.count) == int(res_count.count),
          f"{label}: fill total {int(res_fill.count)} == count")
    from collision_tpu_torch.testing import pair_array_to_set

    pairs = res_fill.pairs.cpu().numpy()
    check(pair_array_to_set(pairs, res_fill.count) == expected,
          f"{label}: fill pair set == oracle")
    tail = pairs[min(int(res_fill.count), CAPACITY):]
    check(bool((tail == 0xFFFFFFFF).all()), f"{label}: unused slots hold 0xFFFFFFFF")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; there is no CPU fallback",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from collision_tpu_torch import collide, slabs
    from collision_tpu_torch.kernels import _build, compact, slab_sweep
    from collision_tpu_torch.testing import kdtree_collisions

    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    phase("build", seconds=build_s, ptxas=[
        line.split("ptxas info    : ")[-1] for line in report.splitlines()
        if "Used" in line or "spill" in line or "Compiling entry" in line])

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    coords_np = rng.random((N, 3)).astype("float32")
    radii_np = rng.uniform(0, 1 / N ** 0.5, N).astype("float32")
    coords = torch.from_numpy(coords_np).to(dev)
    radii = torch.from_numpy(radii_np).to(dev)

    # --- the main path, counted ---
    _build.reset_launches()
    res_count = collide(coords, radii, 0, method="slab")
    res_fill = collide(coords, radii, CAPACITY, method="slab")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    phase("main_path", n=N, capacity=CAPACITY, count=int(res_count.count),
          ok=bool(res_count.ok), fill_total=int(res_fill.count),
          fill_ok=bool(res_fill.ok), launches=launches)
    for name, count in launches.items():
        check(count > 0, f"main path launched {name} ({count}x)")

    # --- end to end against the oracle and the plain path ---
    t0 = time.perf_counter()
    expected = kdtree_collisions(coords_np, radii_np)
    phase("oracle", pairs=len(expected), seconds=time.perf_counter() - t0)
    check_against_oracle(res_count, res_fill, expected, f"n={N}")
    with plain_kernels():
        plain_count = collide(coords, radii, 0, method="slab")
        plain_fill = collide(coords, radii, CAPACITY, method="slab")
    check(int(plain_count.count) == int(res_count.count)
          and bool(plain_count.ok) == bool(res_count.ok),
          "count == plain path's count")
    check(torch.equal(plain_fill.pairs, res_fill.pairs),
          "fill pairs == plain path's pairs, bit for bit")
    check_against_oracle(collide(coords, radii, 0, gx=PINNED_GX),
                         collide(coords, radii, CAPACITY, gx=PINNED_GX),
                         expected, f"n={N} gx={PINNED_GX}")

    # --- each kernel against its plain version at the main path's shapes ---
    gx, cap, rows = slabs.default_slab_config(N)
    plan = slabs.plan_slabs(coords, radii, gx, cap, rows)
    args = (plan.stream, plan.starts, plan.w0, plan.wcap)
    kernels = []

    def record(name, source, replaces, err, fn, plain_fn):
        check(err == 0, f"{name}: kernel == plain (max_abs_err {err})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": time_ms(fn, batch=KERNEL_BATCH),
            "plain_ms": time_ms(plain_fn, batch=KERNEL_BATCH)})

    cnt = slab_sweep.slab_count(*args)
    record("slab_count", "collision_tpu_torch/csrc/slab_sweep.cu",
           "collision_tpu/kernels/slab_sweep.py:157",
           abs(int(cnt) - int(slab_sweep.slab_count_plain(*args))),
           lambda: slab_sweep.slab_count(*args),
           lambda: slab_sweep.slab_count_plain(*args))
    masks = slab_sweep.slab_masks(*args)
    plain_masks = slab_sweep.slab_masks_plain(*args)
    check(torch.equal(masks, plain_masks), "slab_masks: torch.equal")
    record("slab_masks", "collision_tpu_torch/csrc/slab_sweep.cu",
           "collision_tpu/kernels/slab_sweep.py:347",
           max_abs_err(masks, plain_masks),
           lambda: slab_sweep.slab_masks(*args),
           lambda: slab_sweep.slab_masks_plain(*args))
    small = slabs.residual_row_mask(plan)[0].reshape(-1)
    dense = torch.rand(small.numel(), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(SEED)) < 0.03
    errs = []
    for mask, capacity in ((small, slabs.RESIDUAL_PAIRS), (dense, CAPACITY)):
        idx, total = compact.compact_mask(mask, capacity)
        pidx, ptotal = compact.compact_mask_plain(mask, capacity)
        errs += [max_abs_err(idx, pidx), abs(int(total) - int(ptotal))]
        phase("compact_case", elements=mask.numel(), capacity=capacity,
              total=int(total), plain_total=int(ptotal))
    check(int(dense.sum()) > CAPACITY, "dense compact case truncates")
    record("compact_mask", "collision_tpu_torch/csrc/compact.cu",
           "collision_tpu/kernels/compact.py:48", max(errs),
           lambda: compact.compact_mask(small, slabs.RESIDUAL_PAIRS),
           lambda: compact.compact_mask_plain(small, slabs.RESIDUAL_PAIRS))

    # --- step times, kernel path and plain path ---
    steps = {}
    for label, capacity in (("count_step", 0), ("fill_step", CAPACITY)):
        steps[label + "_ms"] = time_ms(
            lambda: collide(coords, radii, capacity, method="slab"))
        with plain_kernels():
            steps[label + "_plain_ms"] = time_ms(
                lambda: collide(coords, radii, capacity, method="slab"))
    phase("steps", n=N, **steps)

    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILURES:
        print("chip_smoke: failed: " + "; ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
