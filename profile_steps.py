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
- ``launch``: the grid count kernel at 1M (grid_dim 24 and 25, through
  ``emit.count_launch``), the big count and the big emission kernel on
  the power-law and giants routes' parked plans (a raw launch, row
  ranges, counts and first slots computed once), the column masks
  kernel on the dense exact plan (rpw 12), the 1M column plan (rpw 2)
  and the power-law route's parked column plan (rpw 3), and the column
  count kernels, rolled and aligned, at rpw 2 on the 1M plan, on
  ``auto``'s 262144-sphere plan and on the power-law parked plan (the
  rolled one is the dual count's launch there), and the slab count and
  masks kernels at one row on the 1M slab plan (the count also as
  ``slab_count_diag``'s cross-only pass: offset x+1, j > i + 48) and at
  two rows on the giants route's parked slab plan, windows clamped to
  the rows as the dual dispatch and the slab fill clamp them, the grid
  emission kernel on the 1M grid fill's inputs at capacity 16384 (its
  own entries with the hit count on the card, and the hit tiles alone)
  and the diagonal count kernel at d_max 48 on the 1M slab plan, median
  of 15 samples of 20 calls in a row: the launches queue, so the time
  is the kernel's device time.

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
    r"::(slab_count_kernel<(?:true|false)>|slab_masks_kernel|"
    r"column_count_kernel<(?:true|false)>|column_masks_kernel|compact_kernel|"
    r"big_count_kernel|big_emit_kernel|pair_emit_kernel|row_popcount_kernel|"
    r"grid_count_kernel|grid_emit_kernel|"
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


def queued(fn, batch=20, reps=15):
    """Median CUDA-event ms per call over ``batch`` calls in a row."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / batch)
    return statistics.median(ms)


def big_count_launcher(coords, radii, route):
    """A raw launch of the big count kernel on a scene's parked plan for
    its hetero route (chip_smoke.HETERO_ROUTES), row ranges computed
    once."""
    import torch
    from collision_tpu_torch.kernels import _build, bigpass

    bigs, plan = parked_plan(coords, radii, route)
    stream = plan.stream
    c0, c1, n_always = bigpass._row_ranges(stream, bigs[1], bigs[2])
    total = torch.zeros((1,), dtype=torch.int64, device=stream.device)

    def launch():
        # The closure holds the tensors, so their memory stays theirs.
        _build.launch("big_count_launch", bigs[0].data_ptr(), c0.data_ptr(),
                      c1.data_ptr(), n_always, stream.data_ptr(),
                      stream.shape[0], None, total.data_ptr())
    return launch


def parked_plan(coords, radii, route):
    """(bigs, plan) of a scene's parked plan for its hetero route
    (chip_smoke.HETERO_ROUTES)."""
    from collision_tpu_torch import columns, hetero, slabs

    _, _, parked, bigs = hetero._split(coords, radii, None)
    if route[0] == "column":
        return bigs, columns.plan_columns(coords, parked, *route[1:4])
    return bigs, slabs.plan_slabs(coords, parked, *slabs.default_slab_config(
        coords.shape[0], gx=route[1]))


def big_emit_launcher(coords, radii, route, capacity):
    """A raw launch of the big emission kernel on a scene's parked plan,
    from row counts, ranges and first slots computed once."""
    import chip_smoke

    bigs, plan = parked_plan(coords, radii, route)
    return chip_smoke.big_emit_launcher(bigs, plan.stream, capacity)[0]


def column_masks_launcher(plan, rpw):
    """A raw launch of the column masks kernel on a column plan, into
    one buffer allocated once."""
    import torch
    from collision_tpu_torch.kernels import _build, sweep

    ncols, mc = plan.gxy ** 2, plan.mc
    kg, ng = sweep.mask_groups(mc, rpw)
    out = torch.empty((ncols * ng, kg * sweep.NOFF * rpw * 2, 128),
                      dtype=torch.int32, device=plan.stream.device)

    def launch():
        _build.launch("sweep_masks_launch", plan.stream.data_ptr(),
                      plan.starts.data_ptr(), plan.w0.data_ptr(),
                      plan.wcap.data_ptr(), ncols, mc, rpw, kg, ng,
                      out.data_ptr())
    return launch


def column_count_launcher(plan, rpw, rolled):
    """A raw launch of a column count kernel on a column plan, adding
    into one total allocated once."""
    import torch
    from collision_tpu_torch.kernels import _build

    total = torch.zeros((1,), dtype=torch.int64, device=plan.stream.device)

    def launch():
        _build.launch("sweep_count_launch", plan.stream.data_ptr(),
                      plan.starts.data_ptr(), plan.w0.data_ptr(),
                      plan.wcap.data_ptr(), plan.gxy ** 2, plan.mc, rpw,
                      int(rolled), total.data_ptr())
    return launch


def slab_launcher(plan, rpw, masks=False, first_off=0, dmin=0):
    """A raw launch of the slab count (into one total allocated once) or
    masks kernel (into one buffer) on a slab plan, at ``rpw`` rolled rows
    with its windows clamped to rpw*128 lanes, as the dual dispatch and
    the slab fill run it."""
    import torch
    from collision_tpu_torch.kernels import _build, sweep

    wcap = torch.clamp_max(plan.wcap, rpw * 128)
    kg, ng = sweep.mask_groups(plan.mc, rpw)
    if masks:
        out = torch.empty((plan.gx * ng, kg * 2 * rpw * 2, 128),
                          dtype=torch.int32, device=plan.stream.device)
        tail = ("slab_masks_launch", kg, ng)
    else:
        out = torch.zeros((1,), dtype=torch.int64, device=plan.stream.device)
        tail = ("slab_count_launch", first_off, dmin)

    def launch():
        # The closure holds the tensors, so their memory stays theirs.
        _build.launch(tail[0], plan.stream.data_ptr(), plan.starts.data_ptr(),
                      plan.w0.data_ptr(), wcap.data_ptr(), plan.gx, plan.mc,
                      rpw, *tail[1:], out.data_ptr())
    return launch


def grid_emit_launcher(bins, gd, mc, capacity, fill):
    """A raw launch of the grid emission kernel into one buffer on the
    grid fill's inputs at ``capacity``: its own entries (every entry of
    the compacted hit list) and hit count when ``fill``, else the hit
    tiles alone."""
    import torch
    from collision_tpu_torch.kernels import _build, emit

    flat = emit.halo_tile_counts(bins, gd, mc).reshape(-1)
    n_hit = None
    if fill:
        tiles, bases, n_hit = emit.fill_entries(flat, capacity)
    else:
        tiles = torch.nonzero(flat).flatten()
        bases = (torch.cumsum(flat, 0) - flat)[tiles]
    pairs = torch.empty((capacity, 2), dtype=torch.int32, device=bins.device)

    def launch():
        # The closure holds the tensors, so their memory stays theirs.
        _build.launch("grid_emit_launch", bins.data_ptr(), gd, mc,
                      emit.tile_pad(gd), tiles.data_ptr(), bases.data_ptr(),
                      tiles.numel(), None if n_hit is None
                      else n_hit.data_ptr(), capacity, pairs.data_ptr())
    return launch


def diag_launcher(plan, d_max):
    """A raw launch of the diagonal count kernel on a slab plan, into one
    pair of counts allocated once."""
    import torch
    from collision_tpu_torch.kernels import _build, slab_sweep

    out = torch.zeros((2,), dtype=torch.int64, device=plan.stream.device)
    positions = slab_sweep._diag_positions(plan.stream, d_max)

    def launch():
        # The closure holds the tensors, so their memory stays theirs.
        _build.launch("diag_count_launch", plan.stream.data_ptr(),
                      plan.diag_thr.data_ptr(), positions, d_max,
                      out.data_ptr())
    return launch


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

    from chip_smoke import (AUTO_SCENES, DENSE_CAPACITY, DENSE_N, DENSE_R,
                            DENSE_ROUTE, DIAG_D_MAX, F64_CAPACITY, GRID_ODD,
                            HETERO_CAPACITY, HETERO_ROUTES, giants_scene,
                            powerlaw_scene, uniform_scene)
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
                  "slab_count_kernel<false>"),
        "fill": (lambda: collide(coords, radii, CAPACITY, method="slab"),
                 "slab_masks_kernel"),
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
    # After the profiles, so that these launches stay out of them.
    _, _, a_coords, a_radii = uniform_scene(AUTO_SCENES[0][0], dev)
    aplan = columns.plan_columns(a_coords, a_radii,
                                 *columns.default_column_config(
                                     AUTO_SCENES[0][0]))
    pl_route = HETERO_ROUTES["hetero_powerlaw"][0]
    pl_plan = parked_plan(pl_coords, pl_radii, pl_route)[1]
    gi_plan = parked_plan(gi_coords, gi_radii,
                          HETERO_ROUTES["hetero_giants"][0])[1]
    launches = {
        "grid_count_gd24": lambda: grid_emit.count_launch(gbins, *gcfg,
                                                          False),
        "grid_count_gd25": lambda: grid_emit.count_launch(
            gbins_odd, GRID_ODD, gcfg[1], False),
        "big_count_powerlaw": big_count_launcher(
            pl_coords, pl_radii, HETERO_ROUTES["hetero_powerlaw"][0]),
        "big_count_giants": big_count_launcher(
            gi_coords, gi_radii, HETERO_ROUTES["hetero_giants"][0]),
        "big_emit_powerlaw": big_emit_launcher(
            pl_coords, pl_radii, HETERO_ROUTES["hetero_powerlaw"][0],
            HETERO_CAPACITY),
        "big_emit_giants": big_emit_launcher(
            gi_coords, gi_radii, HETERO_ROUTES["hetero_giants"][0],
            HETERO_CAPACITY),
        "column_masks_dense": column_masks_launcher(
            columns.plan_columns(de_coords, de_radii, DENSE_ROUTE["gxy"],
                                 DENSE_ROUTE["col_capacity"],
                                 DENSE_ROUTE["slab_rows"]),
            DENSE_ROUTE["rpw"]),
        "column_masks_1m": column_masks_launcher(cplan, 2),
        "column_masks_powerlaw": column_masks_launcher(pl_plan, pl_route[4]),
        "slab_count_1m": slab_launcher(plan, 1),
        "slab_count_cross_1m": slab_launcher(plan, 1, first_off=1,
                                             dmin=DIAG_D_MAX),
        "slab_masks_1m": slab_launcher(plan, 1, masks=True),
        "slab_count_giants": slab_launcher(gi_plan, 2),
        "slab_masks_giants": slab_launcher(gi_plan, 2, masks=True),
        "grid_emit_fill_1m": grid_emit_launcher(gbins, *gcfg, CAPACITY, True),
        "grid_emit_hits_1m": grid_emit_launcher(gbins, *gcfg, CAPACITY,
                                                False),
        "diag_count_1m": diag_launcher(plan, DIAG_D_MAX)}
    for name, p in (("1m", cplan), ("262144", aplan), ("powerlaw", pl_plan)):
        for rolled, kind in ((True, "rolled"), (False, "aligned")):
            launches[f"column_count_{kind}_{name}"] = column_count_launcher(
                p, 2, rolled)
    for name, fn in launches.items():
        emit("launch", name=name, ms=queued(fn))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
