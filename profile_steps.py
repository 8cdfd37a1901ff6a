"""Device profile of collision_tpu_torch's count and fill steps on one
NVIDIA GPU, for the slab, the column, the hetero and the grid engine.

    python3 profile_steps.py [--out DIR]

The scenes are chip_smoke.py's, 1M spheres from seed 4: uniform, radii
U(0, 1/sqrt(n)), each engine's default config (the grid engine's: 24
cells a side, 120 slots a cell); and the two mixed-radii
scenes that ``auto`` sends to the hetero engine (power-law radii, whose
S-S pass runs on the column engine, and 512 giants among uniform radii,
whose S-S pass runs on the slab engine), count and a fill with room for
every pair; and the reference's dense scene (307200 spheres, radii
U(0, 0.06), 107,651,273 pairs), its exact column attempt and the whole
``Collider.get_collisions`` call with its retry; the diagonal count
(``slab_count_diag`` at d_max 48) on the uniform scene's slab plan; and
the uniform scene's float64 count and fill (capacity 2^21, the
run-expansion fill). Prints one JSON line per reading:

- ``stage``: each stage of a step (plan or bins, sweep or grid count
  kernel, residual jobs, fill), median of 10 samples after warm-up:
  CUDA-event ms around one call, and host enqueue ms (the call
  returning, before the sync).
- ``step``: unprofiled median ms of the whole count and fill steps of
  each engine (``count``, ``fill``: slab; ``column_count``,
  ``column_fill``: column; ``grid_count``, ``grid_fill``: grid;
  ``hetero_powerlaw_*``, ``hetero_giants_*``: ``auto`` on the mixed-radii
  scenes; ``dense_exact_fill``, ``dense_get_collisions``; ``diag_count``:
  slab plan and ``slab_count_diag``; ``float64_count``,
  ``float64_fill``; and two kernels alone, for their device times:
  ``column_count_aligned``, the column count at aligned rows on the
  column plan, and ``grid_halo_count_odd``, the grid count at an odd
  grid_dim 25 through ``halo_pairs``).
- ``profile``: ``STEPS`` steps under ``torch.profiler``, exported as a
  Chrome trace to ``--out`` (default ``build/profile``, gitignored) and
  read back. Device ops per step (kernel, memset and memcpy events),
  device busy ms per step (union of their intervals), profiled wall ms
  per step, and the device's idle share of
  the unprofiled step (1 - busy / step ms) and of the profiled wall. The
  profiler slows the host, so the profiled wall is not the step time.
  The divisor is checked: the step's sweep kernel must appear exactly
  as often as it runs per step (once; twice in ``dense_get_collisions``,
  whose first attempt comes back ok=False); the float64 steps must run
  no hand-written kernel at all.
- ``kernel``: device-only ms per launch of each hand-written kernel, from
  the trace.
- ``top``: the largest device items of each step.

Exits non-zero when there is no CUDA device or the divisor check fails.
"""

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N = 1_000_000
SEED = 4
CAPACITY = 16384
STEPS = 5

#: The hand-written kernels, by their demangled names in the trace.
KERNELS = re.compile(
    r"::(slab_count_kernel<[01], (?:true|false)>|slab_masks_kernel<[01]>|"
    r"column_count_kernel<(?:true|false)>|column_masks_kernel|count_kernel|"
    r"scan_kernel|write_kernel|big_count_kernel|big_emit_kernel|"
    r"pair_emit_kernel|grid_count_kernel|grid_emit_kernel|"
    r"diag_count_kernel)\(")
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def emit(kind, **fields):
    print(json.dumps({kind: fields.pop("name", kind), **fields}), flush=True)


def timed(fn, reps=10, warmup=2):
    """(median CUDA-event ms, median host enqueue ms) of single calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        ev.append(start.elapsed_time(end))
    return statistics.median(ev), statistics.median(host)


def union_ms(intervals):
    """Total length of the union of (start, end) intervals, µs -> ms."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def profile_step(label, fn, steps, step_ms, out_dir, sweep_kernel,
                 per_step=1):
    """Profile ``steps`` calls of ``fn``; returns False if the divisor
    check fails (``sweep_kernel`` launched other than ``per_step`` times
    a step; with ``sweep_kernel`` None, any hand-written kernel
    launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    trace = out_dir / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = union_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / steps
    by_kernel = collections.defaultdict(list)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        m = KERNELS.search(e["name"])
        if m:
            by_kernel[m.group(1)].append(e["dur"] / 1e3)
        item = by_name[e["name"][:100]]
        item[0] += e["dur"] / 1e3 / steps
        item[1] += 1
    sweeps = len(by_kernel.get(sweep_kernel, ())) if sweep_kernel \
        else sum(map(len, by_kernel.values()))
    emit("profile", name=label, steps=steps, device_ops_per_step=len(events) / steps,
         device_busy_ms_per_step=busy, step_ms=step_ms,
         idle_share_of_step=1 - busy / step_ms,
         profiled_wall_ms_per_step=wall, idle_share_of_profiled_wall=1 - busy / wall,
         sweep_kernel_launches=sweeps, trace=str(trace))
    for name, durs in sorted(by_kernel.items()):
        emit("kernel", name=name, step=label, launches=len(durs),
             device_ms_per_launch=statistics.median(durs))
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        emit("top", name=name, step=label, ms_per_step=ms,
             launches_per_step=cnt / steps)
    if sweeps != (steps * per_step if sweep_kernel else 0):
        print(f"profile_steps: {label}: {sweeps} {sweep_kernel} launches in "
              f"{steps} steps", file=sys.stderr)
        return False
    return True


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_steps: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    from chip_smoke import (DENSE_CAPACITY, DENSE_N, DENSE_R, DENSE_ROUTE,
                            DIAG_D_MAX, F64_CAPACITY, GRID_ODD,
                            HETERO_CAPACITY, giants_scene, powerlaw_scene,
                            uniform_scene)
    from collision_tpu_torch import Collider, collide, columns, fill, grid, slabs
    from collision_tpu_torch.collider import default_grid_config
    from collision_tpu_torch.kernels import batched, halo, slab_sweep, sweep
    from collision_tpu_torch.kernels import emit as grid_emit

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    coords = torch.from_numpy(rng.random((N, 3)).astype("float32")).to(dev)
    radii = torch.from_numpy(
        rng.uniform(0, 1 / N ** 0.5, N).astype("float32")).to(dev)
    gx, cap, rows = slabs.default_slab_config(N)
    plan = slabs.plan_slabs(coords, radii, gx, cap, rows)
    args4 = (plan.stream, plan.starts, plan.w0, plan.wcap)
    ccfg = columns.default_column_config(N)
    cplan = columns.plan_columns(coords, radii, *ccfg)
    gcfg = default_grid_config(N)
    gbins = grid.build_grid(coords, radii, *gcfg)[0]
    gbins_odd = grid.build_grid(coords, radii, GRID_ODD, gcfg[1])[0]

    stages = {
        "plan_slabs": lambda: slabs.plan_slabs(coords, radii, gx, cap, rows),
        "slab_count_kernel": lambda: slab_sweep.slab_window_count(*args4),
        "diag_count_kernel": lambda: slab_sweep.diag_count(
            plan.stream, plan.diag_thr, DIAG_D_MAX),
        "slab_count_diag": lambda: slab_sweep.slab_count_diag(plan,
                                                              DIAG_D_MAX),
        "residual_count": lambda: slabs.residual_count(plan),
        "slab_masks_kernel": lambda: slab_sweep.slab_masks(*args4),
        "residual_pairs": lambda: slabs.residual_pairs(plan),
        "slab_fill_from_plan": lambda: fill.slab_fill_from_plan(plan, CAPACITY),
        "plan_columns": lambda: columns.plan_columns(coords, radii, *ccfg),
        "column_count_kernel": lambda: sweep.sweep_count(cplan, 2, True),
        "column_masks_kernel": lambda: sweep.sweep_masks(cplan, 2),
        "mask_fill": lambda: fill.mask_fill(coords, radii, CAPACITY, *ccfg),
        "build_grid": lambda: grid.build_grid(coords, radii, *gcfg),
        "grid_batched_count_kernel": lambda: batched.batched_count(gbins, *gcfg),
        "grid_tile_counts_kernel": lambda: grid_emit.halo_tile_counts(gbins, *gcfg),
        "grid_fill_from_bins": lambda: grid_emit.grid_fill(gbins, *gcfg,
                                                             CAPACITY),
    }
    for name, fn in stages.items():
        ev, host = timed(fn)
        emit("stage", name=name, event_ms=ev, host_enqueue_ms=host)

    _, _, pl_coords, pl_radii = powerlaw_scene(N, dev)
    _, _, gi_coords, gi_radii = giants_scene(N, dev)
    _, _, de_coords, de_radii = uniform_scene(DENSE_N, dev, DENSE_R)
    c64, r64 = coords.double(), radii.double()
    steps = {
        "count": (lambda: collide(coords, radii, 0, method="slab"),
                  "slab_count_kernel<1, false>"),
        "fill": (lambda: collide(coords, radii, CAPACITY, method="slab"),
                 "slab_masks_kernel<1>"),
        "column_count": (lambda: collide(coords, radii, 0, method="column"),
                         "column_count_kernel<true>"),
        "column_fill": (lambda: collide(coords, radii, CAPACITY,
                                        method="column"),
                        "column_masks_kernel"),
        "grid_count": (lambda: collide(coords, radii, 0, method="grid"),
                       "grid_count_kernel"),
        "grid_fill": (lambda: collide(coords, radii, CAPACITY, method="grid"),
                      "grid_emit_kernel"),
        "hetero_powerlaw_count": (lambda: collide(pl_coords, pl_radii, 0),
                                  "big_count_kernel"),
        "hetero_powerlaw_fill": (lambda: collide(pl_coords, pl_radii,
                                                 HETERO_CAPACITY),
                                 "big_emit_kernel"),
        "hetero_giants_count": (lambda: collide(gi_coords, gi_radii, 0),
                                "big_count_kernel"),
        "hetero_giants_fill": (lambda: collide(gi_coords, gi_radii,
                                               HETERO_CAPACITY),
                               "big_emit_kernel"),
        "dense_exact_fill": (lambda: collide(de_coords, de_radii,
                                             DENSE_CAPACITY, **DENSE_ROUTE),
                             "pair_emit_kernel"),
        "dense_get_collisions": (lambda: Collider(DENSE_N).get_collisions(
            de_coords, de_radii, DENSE_CAPACITY), "pair_emit_kernel", 2),
        "diag_count": (lambda: slab_sweep.slab_count_diag(
            slabs.plan_slabs(coords, radii, gx, cap, rows), DIAG_D_MAX),
            "diag_count_kernel"),
        "float64_count": (lambda: collide(c64, r64, 0), None),
        "float64_fill": (lambda: collide(c64, r64, F64_CAPACITY), None),
        "column_count_aligned": (lambda: sweep.sweep_count(cplan, 2, False),
                                 "column_count_kernel<false>"),
        "grid_halo_count_odd": (lambda: halo.halo_pairs(
            gbins_odd, GRID_ODD, gcfg[1], 0), "grid_count_kernel")}
    good = True
    for label, (fn, sweep_kernel, *per_step) in steps.items():
        ev, host = timed(fn, reps=3 if label.startswith("dense") else 10)
        emit("step", name=label, event_ms=ev, host_enqueue_ms=host)
        good &= profile_step(label, fn, STEPS, ev, out_dir, sweep_kernel,
                             *per_step)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
