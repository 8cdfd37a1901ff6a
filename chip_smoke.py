"""Smoke run of collision_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from collision_tpu_torch/csrc and drives the
port's four engines through ``collide``, and the reference's API
through ``Collider`` and ``collide_exact``, on uniform spheres from seed
4, radii U(0, 1/sqrt(n)), as in bench.py, on two mixed-radii scenes and
on the reference's dense scene:

1. the slab engine at 1M spheres, a count-only step and a 16384-capacity
   fill, checked against an independent k-d tree oracle, against the
   same pipeline run with every kernel's plain PyTorch version, and
   again at a pinned gx=300; the slab plan's kernel chain against its
   plain path, every field bit for bit, at 1M and at the benchmark's 16M
   spheres and gx 1000 (``slab_plan_16m``), both timed;
2. the column engine at 1M spheres (``method="column"``, count and fill,
   plus the public ``sweep_count`` at its default aligned rows), checked
   against the same oracle, the slab count and the plain path;
3. ``auto`` below the slab crossovers (262144 spheres with capacity
   16384 and a truncated capacity 1024, 32768 count-only and 16384),
   which must route to the column kernels and match its own oracle;
4. ``auto`` on two mixed-radii scenes at 1M spheres, which must route to
   the hetero engine: the power-law scene (radii (pareto(2.5) + 0.2) /
   sqrt(n), clipped at 0.05), whose S-S pass runs on the column engine,
   and the uniform scene with 512 giants of radius 0.02, whose S-S pass
   runs on the slab engine; each a count and a fill with room for every
   pair, checked against a radius-aware k-d tree oracle, and a truncated
   fill against the plain path;
5. the emission above 2^21 pairs (``big_capacity``): the slab, power-law
   and giants fills again at capacity 2^22, where the pair-emission kernel
   runs on the rolled and the aligned mask layouts, bit-identical to their
   sparse-path prefixes;
6. the reference's own dense scene through its public API
   (``dense_fill``): ``Collider(307200).get_collisions(coords, radii,
   110_000_000)`` on 307200 spheres of radius U(0, 0.06), whose first
   attempt comes back ok=False and whose retry must take the column
   route at exact knobs and return all 107,651,273 pairs: checked against
   the independent count-only call, for strict overlap, self pairs and
   repeats on the card, and bit for bit against the plain path; its four
   column plans each one launch of the column plan chain; the row counts
   (``row_popcounts``), the emission kernel and the column plan chain
   (``column_plan``, every field bit for bit, at the default and the
   exact knobs) against their plain versions at the exact plan;
7. ``collide_exact`` at 65536 spheres of the same radii and capacity 2^23
   (``dense_oracle``), against the k-d tree oracle;
8. the grid engine (``grid``) on the 1M uniform scene at its default
   (grid_dim 24, cell_capacity 120): a count (``batched_count``, which
   launches the one-cell-per-block count kernel) and a 16384-capacity fill
   (tile counts, scan, hit tiles, emission) against the oracle and the
   plain path; the count at an odd grid_dim 25 (the halo count, the same
   kernel); the halo emission (``grid_fill`` under the halo's name)
   against the split fill at 16384 and 1024; a cell overflow (cell_capacity 64) reported as ok=False; and
   ``Collider(65536, method="grid")`` on the dense oracle's scene, whose
   grid attempt overflows and whose retry must return the oracle count;
9. the diagonal count (``diag``): ``slab_count_diag`` at d_max 48 on the
   1M uniform scene's default slab plan, against the oracle with ok, and
   on the same-z cluster (400 spheres in one z plane, d_max 16), which
   must flag (ok=False) while ``slab_count_dual`` stays exact; timed
   beside the dual-dispatch count;
10. float64 (``float64``): ``collide`` count and fill (capacity 2^21) on
   the 1M uniform scene in float64 through ``auto`` and ``"column"``
   (the run-expansion fill, which launches no kernel), against a float64
   k-d tree oracle, and ``Collider(1000, coord_dtype="float64")`` on 1000
   spheres at one point, whose first step overflows the default candidate
   bound and whose retry must return all 499,500 pairs;
11. the grid count and emission, column masks, slab count and masks and
   big pass kernels at the edges of their cull (``cull_edges``,
   collision_tpu_torch/testing/scenes.py): boxes that touch across cell,
   column and slab faces and one ulp across, radii of half a cell, a
   305-row cell beside an empty one, a full column or slab beside an
   empty one, chunks that end inside a mask word, windows from odd
   positions and from a stream row's last lane, windows past 128 lanes,
   the dense oracle scene's grid (grid_dim 8, cell_capacity 192), and
   bigs on the faces of the rows' union boxes beside rows of pad and of
   parked lanes, each against its plain version (tile counts, totals,
   masks, row counts, pair buffers; the slab count at first offsets 0
   and 1 and dmin 0 and 48, the slab masks at one and two rows; the grid
   emission fed the hit tiles alone and the fill's own entries, with and
   without the hit count, at room for every pair, inside a tile, at one
   slot and at a tile boundary).

Each engine's main path, and each of the phases above, runs with the
kernel launch counters reset just before and read just after; the slab
engine's plain path must launch no kernel at all. Each kernel is
compared with its plain version at the shapes its path gives it, and
timed with CUDA events:
the steps one call at a time (closed loop), each kernel and its plain
version over back-to-back calls. Each kernel's record holds its bound:
the larger of the bytes it must move (inputs read once, outputs written
once; of the [Rp, 8, 128] stream only the channels the kernel reads:
the boxes' six for the sweep kernels and the big count, the ids too
for the big pairs) at the H100's 3.35 TB/s and its box tests (six
float compares each, counted from this run's window and chunk tables)
at 67 TFLOP/s float32; the pair emission's bytes are the mask words read once and two
int64 ids written per output slot, sentinels included, and the row
counts' the mask words read once and one int64 count a row. The grid
and big kernels' tests are what these inputs need: occ * (occ - 1) / 2
for a self tile (occ a cell's filled slots), for a neighbour tile the
rows of each cell that meet the other's union box, multiplied, and for
a stream row and a big chunk it visits the chunk's bigs that meet the
row's union box times 128, as the count kernels cull them; their
records print the live tests beside
(``dense_tests``: occ(a) * occ(b), 64 x 128 a visited big chunk). The
sweep kernels' tests, the column and the slab counts' and masks', are
each window lane's against the 32-row mask words whose union box it
meets, as the kernels cull them (beside them, ``dense_tests``, every
live a-row against the window), and these records give both times of
the bound; the diagonal count's record gives both times of its bound and
its tests beside the ones it runs (``dense_tests``: its whole domain,
pads included, against the next d_max), and its phase adds the bound of
its cross-only slab count. The grid emission's record is timed at the
fill's own launch (every entry of the compacted hit list and the hit
count on the card), with the hit tiles alone beside it
(``hit_tiles_ms``). The column count kernels are checked and
timed on the 1M column plan (their records), on ``auto``'s 262144 plan
and on the power-law parked plan (``column_plan_work`` lines, beside
the masks kernel); ``big_pairs``' record adds
its emission pass alone (``emit_pass``: a queued launch, its bound and
tests, on the rows it runs: a pair, a first slot below the capacity;
the bytes are those rows' channels 0-6 and ranges, the big chunks they
visit once, every row's count and first slot, and the ids written). The big count is also checked on the giants plan, its row counts
against the plain ones, and the grid count at both grid_dims.

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
#: ``auto``'s scenes below the slab crossovers: (n, capacities).
AUTO_SCENES = ((262144, (CAPACITY,)), (32768, (0, CAPACITY)))
TRUNC_CAPACITY = 1024
SLAB_KERNELS = ("slab_count", "slab_masks", "compact_mask", "row_popcounts",
                "slab_plan")
#: The benchmark's slab scene: 16M spheres at a pinned gx of 1000.
PLAN_16M = (1 << 24, 1000)
COLUMN_KERNELS = ("sweep_count_rolled", "sweep_count_aligned", "sweep_masks",
                  "column_plan")
#: The hetero scenes' fill capacity: room for every pair of both.
HETERO_CAPACITY = 1 << 19
#: Spheres given radius GIANT_RADIUS in the giants scene.
GIANTS = 512
GIANT_RADIUS = 0.02
#: (engine and knobs "auto" must route to, kernels its path launches).
HETERO_ROUTES = {
    "hetero_powerlaw": (("column", 26, 1728, 313, 3),
                        ("big_count", "big_pairs", "sweep_count_rolled",
                         "sweep_masks", "compact_mask", "row_popcounts",
                         "column_plan")),
    "hetero_giants": (("slab", 146),
                      ("big_count", "big_pairs", "slab_count", "slab_masks",
                       "compact_mask", "row_popcounts", "slab_plan")),
}
#: The fills rerun past BIG_FILL_THRESHOLD, where the emission kernel runs.
BIG_CAPACITY = 1 << 22
#: The reference's dense benchmark scene: n, radius bound, the capacity
#: it is called with, its pair count and the route of the exact attempt
#: (computed with the JAX package's host code from the same scene).
DENSE_N = 307200
DENSE_R = 0.06
DENSE_CAPACITY = 110_000_000
DENSE_PAIRS = 107_651_273
DENSE_ROUTE = {"method": "column", "gxy": 14, "col_capacity": 4608,
               "slab_rows": 295, "rpw": 12}
#: Column plans a dense frame builds: auto's attempt, the retry's two
#: statistics plans and the rung's.
DENSE_PLANS = 4
#: The dense radii at a size the k-d tree oracle checks in seconds.
ORACLE_N = 65536
ORACLE_CAPACITY = 1 << 23
#: (grid_dim, cell_capacity) of the grid kernels' check on that scene:
#: cells 1/8 wide, up to 163 spheres a cell.
DENSE_GRID = (8, 192)
#: Pairs per chunk of the on-card checks of the dense buffer.
CHECK_CHUNK = 1 << 24
#: Back-to-back calls per timing sample of a kernel and its plain version.
KERNEL_BATCH = 20
#: Published H100 SXM peaks: HBM bytes/s and float32 FLOP/s outside the
#: tensor cores (NVIDIA's data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: Float compares per box test.
BOX_COMPARES = 6
#: The grid engine's default (grid_dim, cell_capacity) at N, the odd
#: grid_dim its halo count takes, and a cell capacity below N's occupancy.
GRID_CONFIG = (24, 120)
GRID_ODD = 25
GRID_OVERFLOW_CAPACITY = 64
GRID_KERNELS = ("batched_count", "grid_tile_counts", "compact_mask",
                "grid_emit", "grid_bins")
#: The diagonal count's span on the main path, and the same-z cluster
#: that must flag: n, seed, radius, span.
DIAG_D_MAX = 48
FLAG_SCENE = (400, 28, 0.003, 16)
#: The float64 fill's capacity, and the retry scene's size (all spheres
#: at one point, radius F64_RETRY_R).
F64_CAPACITY = 1 << 21
F64_RETRY_N = 1000
F64_RETRY_R = 0.1

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
    from collision_tpu_torch.kernels import (batched, bigpass, column_plan,
                                             compact, emit, grid_bins, halo,
                                             pair_emit, slab_plan, slab_sweep,
                                             sweep)

    swaps = [(grid_bins, "build_bins"), (slab_plan, "build_plan"),
             (column_plan, "build_plan"),
             (slab_sweep, "slab_window_count"), (slab_sweep, "slab_masks"),
             (slab_sweep, "diag_count"),
             (compact, "compact_mask"), (sweep, "sweep_count"),
             (sweep, "sweep_masks"), (bigpass, "big_count_only"),
             (bigpass, "big_pairs"), (pair_emit, "emit_pairs"),
             (pair_emit, "emit_pair_buffer"), (pair_emit, "row_popcounts"),
             (halo, "halo_pairs"), (batched, "batched_count"),
             (emit, "halo_tile_counts"), (emit, "emit_pairs")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_count(res, expected, label):
    check(bool(res.ok), f"{label}: count ok")
    check(int(res.count) == len(expected),
          f"{label}: count {int(res.count)} == oracle {len(expected)}")


def check_fill(res, expected, label):
    """A fill with room for every pair: ok, the true total, the oracle's
    pair set, and 0xFFFFFFFF in every unused slot."""
    from collision_tpu_torch.testing import pair_array_to_set

    check(bool(res.ok), f"{label}: fill ok")
    check(int(res.count) == len(expected),
          f"{label}: fill total {int(res.count)} == oracle")
    pairs = res.pairs.cpu().numpy()
    check(pair_array_to_set(pairs, res.count) == expected,
          f"{label}: fill pair set == oracle")
    tail = pairs[min(int(res.count), len(pairs)):]
    check(bool((tail == 0xFFFFFFFF).all()), f"{label}: unused slots hold 0xFFFFFFFF")


def check_against_oracle(res_count, res_fill, expected, label):
    check_count(res_count, expected, label)
    check_fill(res_fill, expected, label)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def stream_bytes(stream, channels=6):
    """Bytes of ``channels`` of the [Rp, 8, 128] stream's 8 channels: the
    sweep kernels and the big count read the boxes' six (0-5), never the
    ids (6) or channel 7."""
    return nbytes(stream) * channels // 8


def sweep_bytes(plan):
    """Bytes a sweep kernel reads of a slab or column plan: the stream's
    box channels and the window and chunk tables, once."""
    return stream_bytes(plan.stream) + nbytes(plan.starts, plan.w0, plan.wcap)


def bounds(moved, tests):
    """{"bytes_ms", "operations_ms"}: the times a kernel that moves
    ``moved`` bytes and runs ``tests`` box tests takes at least, on the
    published peaks, for each."""
    return {"bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
            "operations_ms": tests * BOX_COMPARES / F32_OPS_PER_S * 1e3}


def bound(moved, tests):
    """(bound_ms, bound_by): the larger of :func:`bounds`."""
    b = bounds(moved, tests)
    return (b["bytes_ms"], "bytes") if b["bytes_ms"] >= b["operations_ms"] \
        else (b["operations_ms"], "operations")


def window_tests(starts, w0, wcap, mc, noff, rpw, rolled, first_off=0):
    """Box tests a sweep kernel runs on a plan: each live a-row of each
    chunk against the window lanes its ``rpw`` rows cover, on offsets
    ``first_off`` .. noff-1."""
    import torch

    nb = w0.numel() // (mc * noff)
    g0 = starts[:nb, None].long() + torch.arange(mc, device=w0.device) * 64
    alen = (starts[1:nb + 1, None].long() - g0).clamp(0, 64)
    w = w0.reshape(nb, mc, noff).long()
    wc = wcap.reshape(nb, mc, noff).long()
    if rolled:
        lanes = wc.clamp(max=rpw * 128)
    else:
        lanes = (torch.minimum(w + wc, (w // 128 + rpw) * 128) - w).clamp(min=0)
    return int((alen[..., None] * lanes[..., first_off:]).sum())


def mask_tests(plan, rpw, rolled=False, noff=5, first_off=0, dmin=0):
    """(tests, dense_tests) of a sweep kernel on a column plan (``noff``
    5) or a slab plan (``noff`` 2) at ``rpw`` window rows, aligned or
    ``rolled``, on offsets ``first_off`` .. noff-1. ``dense_tests``: every
    live a-row of each chunk against the window lanes its ``rpw`` rows
    cover (:func:`window_tests`). ``tests``: what these inputs need after
    an exact cull, the column kernels' first: for each such lane and each
    32-row mask word, the word's live a-rows if the lane meets the word's
    union box (min lo, max hi over its live a-rows, xlo below +inf) and,
    on the self offset (on every offset when ``dmin`` > 0), lies more than
    ``dmin`` past one of them, else none."""
    import torch

    inf = float("inf")
    mc = plan.mc
    nb = plan.w0.numel() // (mc * noff)
    comps = plan.stream[:, :6, :].permute(1, 0, 2).reshape(6, -1)
    starts = plan.starts.long()
    w0 = plan.w0.reshape(nb, mc, noff)[:, :, first_off:].long()
    wc = plan.wcap.reshape(nb, mc, noff)[:, :, first_off:].long()
    dev = comps.device
    k = torch.arange(rpw * 128, device=dev)
    tests = 0
    step = max(1, (1 << 22) // (mc * noff * rpw * 128))
    for c0 in range(0, nb, step):
        c1 = min(nb, c0 + step)
        g0 = starts[c0:c1, None] + torch.arange(mc, device=dev) * 64
        alen = (starts[c0 + 1:c1 + 1, None] - g0).clamp(0, 64)     # [b, mc]
        i = g0[..., None] + torch.arange(64, device=dev)
        a = comps[:, i.clamp(max=comps.shape[1] - 1)]             # [6, b, mc, 64]
        live = (torch.arange(64, device=dev) < alen[..., None]) & (a[0] < inf)
        ulo = torch.where(live, a[:3], inf).unflatten(-1, (2, 32)).amin(-1)
        uhi = torch.where(live, a[3:], -inf).unflatten(-1, (2, 32)).amax(-1)
        w, n = w0[c0:c1, :, :, None], wc[c0:c1, :, :, None]
        # The window lanes j = w + k, k below the lanes the rows cover.
        if rolled:
            lanes = n.clamp(max=rpw * 128)
        else:
            lanes = torch.minimum(w + n, (w // 128 + rpw) * 128) - w
        j = w + k                                              # [b, mc, noff, L]
        in_win = k < lanes
        b = comps[:, j.clamp(max=comps.shape[1] - 1)][..., None]  # [6, ..., 1]
        at = (slice(None), slice(None), slice(None), None, None)
        meets = ((uhi[at] > b[:3]) & (ulo[at] < b[3:])).all(0)    # [..., 2]
        below = j[..., None] - g0[:, :, None, None, None] \
            - torch.tensor([0, 32], device=dev) > dmin
        if dmin:
            meets &= below
        elif first_off == 0:
            meets[:, :, 0] &= below[:, :, 0]
        per_word = torch.stack([alen.clamp(max=32), (alen - 32).clamp(min=0)],
                               -1)[:, :, None, None, :]
        tests += int(((meets & in_win[..., None]) * per_word).sum())
    return tests, window_tests(plan.starts, plan.w0, plan.wcap, mc, noff,
                               rpw, rolled, first_off)


def big_visits(bigs, stream):
    """(visit, nvis): bool [Rp, nbc], the big chunks each stream row
    visits, and their number a row."""
    import torch
    from collision_tpu_torch.kernels import bigpass

    c0, c1, n_always = bigpass._row_ranges(stream, bigs[1], bigs[2])
    c = torch.arange(bigs[0].shape[0], device=stream.device)
    visit = (c < n_always) | ((c >= c0[:, None]) & (c < c1[:, None]))
    return visit, (n_always + c1 - c0).long()


def big_tests(bigs, stream, rows=None):
    """(tests, dense_tests) of the big pass. ``dense_tests``: 64 x 128 per
    (stream row, visited big chunk), every big against every lane.
    ``tests``: what these inputs need, the bigs of each visited chunk
    that meet the row's union box (min lo, max hi over its live lanes,
    xlo below +inf) times 128, as the kernels cull them. With ``rows``
    (bool per stream row), only those rows count, as the emission skips
    the others."""
    import torch

    table = bigs[0]
    visit, nvis = big_visits(bigs, stream)
    inf = float("inf")
    live = (stream[:, 0, :] < inf)[:, None, :]
    ulo = torch.where(live, stream[:, 0:3, :], inf).amin(-1)[:, None, None]
    uhi = torch.where(live, stream[:, 3:6, :], -inf).amax(-1)[:, None, None]
    meets = ((table[None, :, :, 3:6] > ulo) & (table[None, :, :, 0:3] < uhi)) \
        .all(-1)                                          # [Rp, nbc, 64]
    per_row = (meets & visit[..., None]).sum((1, 2))
    if rows is not None:
        per_row, nvis = per_row[rows], nvis[rows]
    return int(per_row.sum()) * 128, int(nvis.sum()) * 64 * 128


def big_row_counts(bigs, stream):
    """(the count kernel's int32 row counts, the plain row counts): the
    counts ``big_pairs`` scans for its bases. A direct launch, outside
    the wrappers' launch counts."""
    import torch
    from collision_tpu_torch.kernels import bigpass

    got = torch.empty((stream.shape[0],), dtype=torch.int32,
                      device=stream.device)
    c0, c1, n_always = bigpass.count_launch(bigs, stream, got, None)
    want = bigpass._tile_hits_plain(bigs[0], c0, c1, n_always, stream, 0,
                                    stream.shape[0]).sum((1, 2, 3))
    return got, want


def column_plan_work(plan, rpw, label, count_rpw):
    """The column kernels against their plain versions on one plan: the
    masks at ``rpw`` rows, the counts at ``count_rpw`` rows (rolled and
    aligned rows). Each is timed over back-to-back calls (``ms``, the
    wrapper included) and bounded there (the stream's box channels and
    the tables read once, the masks written once) by the tests an exact
    cull leaves (:func:`mask_tests`; beside them the window's). Returns
    the fields by name (``count_rolled``, ``count_aligned``, ``masks``)."""
    import torch
    from collision_tpu_torch.kernels import sweep

    masks = sweep.sweep_masks(plan, rpw)
    check(torch.equal(masks, sweep.sweep_masks_plain(plan, rpw)),
          f"{label}: column masks kernel == plain at rpw {rpw}")
    tables = sweep_bytes(plan)
    out = {}
    for rolled, name in ((True, "count_rolled"), (False, "count_aligned")):
        got = int(sweep.sweep_count(plan, count_rpw, rolled))
        want = int(sweep.sweep_count_plain(plan, count_rpw, rolled))
        check(got == want, f"{label}: column {name} kernel {got} == plain "
              f"{want} at rpw {count_rpw}")
        tests, window = mask_tests(plan, count_rpw, rolled)
        by = bound(tables + 8, tests)
        out[name] = {"count": got, "max_abs_err": abs(got - want),
                     "ms": time_ms(lambda: sweep.sweep_count(
                         plan, count_rpw, rolled), batch=KERNEL_BATCH),
                     "tests": tests, "dense_tests": window, "bound_ms": by[0],
                     "bound_by": by[1], **bounds(tables + 8, tests)}
    tests, window = mask_tests(plan, rpw)
    by = bound(tables + nbytes(masks), tests)
    out["masks"] = {"ms": time_ms(lambda: sweep.sweep_masks(plan, rpw),
                                  batch=KERNEL_BATCH),
                    "tests": tests, "dense_tests": window,
                    "bound_ms": by[0], "bound_by": by[1],
                    **bounds(tables + nbytes(masks), tests)}
    phase("column_plan_work", plan=label, rpw=rpw, count_rpw=count_rpw,
          **out)
    return out


def big_emit_launcher(bigs, stream, capacity):
    """(launch, inputs): a raw launch of the big emission kernel, outside
    the wrappers' launch counts, on the row counts, ranges and first
    slots that one count launch gives; ``inputs`` holds those tensors
    (counts, c0, c1, bases)."""
    import torch
    from collision_tpu_torch.kernels import _build, bigpass

    counts = torch.empty((stream.shape[0],), dtype=torch.int32,
                         device=stream.device)
    c0, c1, n_always = bigpass.count_launch(bigs, stream, counts, None)
    bases = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    ida = torch.empty((capacity,), dtype=torch.int32, device=stream.device)
    idb = torch.empty_like(ida)

    def launch():
        # The closure holds the tensors, so their memory stays theirs.
        _build.launch("big_emit_launch", bigs[0].data_ptr(), c0.data_ptr(),
                      c1.data_ptr(), n_always, stream.data_ptr(),
                      stream.shape[0], counts.data_ptr(), bases.data_ptr(),
                      capacity, ida.data_ptr(), idb.data_ptr())
    return launch, (counts, c0, c1, bases)


def big_emit_pass(bigs, stream, capacity):
    """The emission kernel of ``big_pairs`` alone: its queued launch time
    and its bound. By bytes: the row counts and first slots of every row;
    for the rows it runs (a pair, a first slot below ``capacity``) their
    ranges and channels 0-6 of their lanes; the big chunks those rows
    visit, once; two int32 ids written a pair below ``capacity``. By
    operations: the culled tests of those rows (beside them 64 x 128 a
    visited chunk of those rows)."""
    import torch

    launch, (counts, c0, c1, bases) = big_emit_launcher(bigs, stream, capacity)
    run = (counts > 0) & (bases < capacity)
    visit, _ = big_visits(bigs, stream)
    nrun = int(run.sum())
    pairs = min(int(counts.sum()), capacity)
    moved = nbytes(counts, bases) \
        + nrun * (nbytes(stream[0, :7]) + c0.element_size() + c1.element_size()) \
        + int(visit[run].any(0).sum()) * nbytes(bigs[0][0]) + 8 * pairs
    tests, dense = big_tests(bigs, stream, run)
    bound_ms, bound_by = bound(moved, tests)
    return {"ms": time_ms(launch, batch=KERNEL_BATCH), "bound_ms": bound_ms,
            "bound_by": bound_by, **bounds(moved, tests), "tests": tests,
            "dense_tests": dense, "rows_run": nrun, "pairs": pairs}


def powerlaw_scene(n, dev):
    """The JAX package's 1M reference scene for mixed radii: centers
    U[0,1)^3 from SEED, radii (pareto(2.5) + 0.2) / sqrt(n), clipped at
    0.05."""
    import torch

    rng = np.random.RandomState(SEED)
    coords_np = rng.random((n, 3)).astype("float32")
    radii_np = np.clip((1 / n ** 0.5) * (rng.pareto(2.5, n) + 0.2), 0,
                       0.05).astype("float32")
    return (coords_np, radii_np, torch.from_numpy(coords_np).to(dev),
            torch.from_numpy(radii_np).to(dev))


def giants_scene(n, dev):
    """The uniform scene with its first GIANTS spheres at GIANT_RADIUS:
    a few hundred large bodies among small particles."""
    import torch

    coords_np, radii_np, _, _ = uniform_scene(n, dev)
    radii_np[:GIANTS] = GIANT_RADIUS
    return (coords_np, radii_np, torch.from_numpy(coords_np).to(dev),
            torch.from_numpy(radii_np).to(dev))


def hetero_route(coords, radii):
    """The S-S engine and knobs "auto" derives for a scene, or None when
    its probe finds the scene uniform."""
    from collision_tpu_torch import collider

    n = coords.shape[0]
    stats = collider._route_hetero_eager(coords, radii)
    if stats is None:
        return None
    return collider._hetero_route_knobs(n, collider._effective_nb(n, None),
                                        *stats)


def hetero_path(name, scene, dev):
    """Drive ``auto`` on one mixed-radii scene at N spheres: the route,
    the launches of its count and full fill, the oracle, and a truncated
    fill against the plain path. Returns (coords, radii, launches, full
    fill)."""
    import torch
    from collision_tpu_torch import collide
    from collision_tpu_torch.testing import kdtree_collisions, pair_array_to_set

    t0 = time.perf_counter()
    coords_np, radii_np, coords, radii = scene(N, dev)
    want_knobs, want_kernels = HETERO_ROUTES[name]
    knobs = hetero_route(coords, radii)
    check(knobs == want_knobs, f"{name}: auto routes to hetero {knobs}")
    (res_count, res_fill), run = counted(lambda: (
        collide(coords, radii, 0), collide(coords, radii, HETERO_CAPACITY)))
    for kernel, ran in run.items():
        check((ran > 0) == (kernel in want_kernels),
              f"{name}: {kernel} launched {ran}x")
    t1 = time.perf_counter()
    expected = kdtree_collisions(coords_np, radii_np)
    oracle_s = time.perf_counter() - t1
    check_count(res_count, expected, name)
    check_fill(res_fill, expected, name)
    cut = collide(coords, radii, CAPACITY)
    with plain_kernels():
        plain_cut = collide(coords, radii, CAPACITY)
    check(bool(cut.ok) and int(cut.count) == len(expected)
          and bool(plain_cut.ok) and int(plain_cut.count) == len(expected),
          f"{name} capacity {CAPACITY}: true total, kernel and plain path")
    check(torch.equal(cut.pairs, plain_cut.pairs),
          f"{name} capacity {CAPACITY}: pairs == plain path's, bit for bit")
    got = pair_array_to_set(cut.pairs.cpu().numpy(), CAPACITY)
    check(len(got) == CAPACITY and got <= expected,
          f"{name} capacity {CAPACITY}: distinct oracle pairs")
    phase(name, n=N, knobs=knobs, pairs=len(expected),
          count=int(res_count.count), ok=bool(res_count.ok),
          fill_capacity=HETERO_CAPACITY, fill_total=int(res_fill.count),
          fill_ok=bool(res_fill.ok), launches=run, oracle_seconds=oracle_s,
          seconds=time.perf_counter() - t0)
    return coords, radii, run, res_fill


def uniform_scene(n, dev, r_max=None):
    """(coords, radii) numpy float32 and on the card: n uniform spheres
    from SEED, radii U(0, r_max), by default U(0, 1/sqrt(n))."""
    import torch

    rng = np.random.RandomState(SEED)
    coords_np = rng.random((n, 3)).astype("float32")
    radii_np = rng.uniform(0, 1 / n ** 0.5 if r_max is None else r_max,
                           n).astype("float32")
    return (coords_np, radii_np, torch.from_numpy(coords_np).to(dev),
            torch.from_numpy(radii_np).to(dev))


def big_capacity(cases):
    """Each (label, fill at BIG_CAPACITY, the same scene's sparse-path
    fill): the pair-emission kernel launched once, the same ok and count,
    the sparse fill's pairs bit for bit, 0xFFFFFFFF after them."""
    import torch

    for label, fill_fn, sparse in cases:
        t0 = time.perf_counter()
        res, run = counted(fill_fn)
        k = min(int(sparse.count), sparse.pairs.shape[0])
        check(run["pair_emit"] == 1,
              f"{label} capacity {BIG_CAPACITY}: pair_emit launched "
              f"{run['pair_emit']}x")
        check(bool(res.ok) and int(res.count) == int(sparse.count)
              and bool(sparse.ok),
              f"{label} capacity {BIG_CAPACITY}: ok, count {int(res.count)}")
        check(torch.equal(res.pairs[:k], sparse.pairs[:k]),
              f"{label} capacity {BIG_CAPACITY}: == sparse-path pairs, bit "
              "for bit")
        check(bool((res.pairs[int(res.count):] == 0xFFFFFFFF).all()),
              f"{label} capacity {BIG_CAPACITY}: 0xFFFFFFFF past the count")
        phase("big_capacity", scene=label, capacity=BIG_CAPACITY,
              count=int(res.count), launches=run,
              seconds=time.perf_counter() - t0)


def check_pair_buffer(pairs, count, coords, radii, label):
    """On the card, in chunks: every pair's ids in range, its boxes
    strictly overlapping on all 3 axes, no self pair, no unordered pair
    twice (sorted min*n + max keys), 0xFFFFFFFF past the count. Unique,
    truly overlapping pairs as many as an independent count are the true
    set."""
    import torch

    n = coords.shape[0]
    k = int(count)
    lo, hi = coords - radii[:, None], coords + radii[:, None]
    keys = torch.empty((k,), dtype=torch.int64, device=coords.device)
    in_range = overlap = no_self = True
    for s in range(0, k, CHECK_CHUNK):
        a, b = pairs[s:min(s + CHECK_CHUNK, k)].unbind(1)
        in_range &= bool(((a >= 0) & (a < n) & (b >= 0) & (b < n)).all())
        if not in_range:
            break
        overlap &= bool(((hi[a] > lo[b]) & (lo[a] < hi[b])).all())
        no_self &= bool((a != b).all())
        keys[s:s + a.shape[0]] = torch.minimum(a, b) * n + torch.maximum(a, b)
    check(in_range, f"{label}: every id < n")
    check(overlap, f"{label}: every pair's boxes overlap on all 3 axes")
    check(no_self, f"{label}: no self pair")
    keys = torch.sort(keys).values
    check(bool((keys[1:] != keys[:-1]).all()), f"{label}: no pair repeats")
    check(bool((pairs[k:] == 0xFFFFFFFF).all()),
          f"{label}: 0xFFFFFFFF past the count")


def dense_fill(dev, record, launches):
    """The reference's dense scene through ``Collider.get_collisions``:
    the route, launches, count and pairs of its attempts, the count-only
    call, the buffer checks, the plain path, step times and the emission
    kernel's record, whose launches are the fill's (``launches``)."""
    import torch
    from collision_tpu_torch import Collider, collide, collider, columns, fill
    from collision_tpu_torch.kernels import _build, pair_emit, sweep

    t0 = time.perf_counter()
    _, _, coords, radii = uniform_scene(DENSE_N, dev, DENSE_R)
    attempts = []
    direct = collider.collide

    def spy(*args, **kwargs):
        before = _build.LAUNCHES["pair_emit"]
        res = direct(*args, **kwargs)
        attempts.append({"knobs": kwargs, "ok": bool(res.ok),
                         "count": int(res.count),
                         "pair_emit": _build.LAUNCHES["pair_emit"] - before})
        return res

    torch.cuda.reset_peak_memory_stats()
    collider.collide = spy
    try:
        (count, pairs), run = counted(lambda: Collider(DENSE_N).get_collisions(
            coords, radii, DENSE_CAPACITY))
    finally:
        collider.collide = direct
    peak = torch.cuda.max_memory_allocated()
    exact = attempts[-1]
    check(len(attempts) == 2 and not attempts[0]["ok"] and exact["ok"],
          f"dense: first attempt not ok, the retry ok ({attempts})")
    check(exact["knobs"] == DENSE_ROUTE,
          f"dense: the exact attempt's route {exact['knobs']}")
    check(exact["pair_emit"] == 1,
          f"dense: the exact attempt launched pair_emit {exact['pair_emit']}x")
    check(run["column_plan"] == DENSE_PLANS,
          f"dense: column_plan launched {run['column_plan']}x")
    check(int(count) == DENSE_PAIRS, f"dense: count {int(count)}")
    count_only = Collider(DENSE_N).get_collisions(coords, radii, 0,
                                                  collisions=None)
    check(int(count_only) == int(count),
          f"dense: count-only {int(count_only)} == fill count")
    check_pair_buffer(pairs, count, coords, radii, "dense")
    route = {k: v for k, v in exact["knobs"].items() if k != "method"}
    with plain_kernels():
        plain = collide(coords, radii, DENSE_CAPACITY, method="column",
                        **route)
    check(torch.equal(plain.pairs, pairs),
          "dense: pairs == plain path's, bit for bit")
    del plain
    step_ms = time_ms(lambda: Collider(DENSE_N).get_collisions(
        coords, radii, DENSE_CAPACITY), warmup=1, reps=3)
    exact_ms = time_ms(lambda: collide(
        coords, radii, DENSE_CAPACITY, method="column", **route),
        warmup=1, reps=3)

    # The emission kernel against its plain version at the exact plan.
    plan = columns.plan_columns(coords, radii, route["gxy"],
                                route["col_capacity"], route["slab_rows"])
    B = sweep.sweep_masks(plan, route["rpw"])
    B_plain = sweep.sweep_masks_plain(plan, route["rpw"])
    err = max_abs_err(B, B_plain)
    del B_plain
    # Row 7's bound at this plan: the stream's box channels and the
    # tables read once, the masks written once, and the tests the
    # kernel's cull leaves (beside them every live a-row against the
    # window lanes).
    mask_culled, mask_window = mask_tests(plan, route["rpw"])
    mask_bytes = sweep_bytes(plan) + nbytes(B)
    record("sweep_masks", "collision_tpu_torch/csrc/sweep.cu",
           "collision_tpu/kernels/sweep.py:382", err,
           lambda: sweep.sweep_masks(plan, route["rpw"]),
           lambda: sweep.sweep_masks_plain(plan, route["rpw"]),
           mask_bytes, mask_culled, plain_batch=1, plain_reps=1,
           dense_tests=mask_window,
           extra={"bound": bounds(mask_bytes, mask_culled)})
    rp = pair_emit.row_popcounts(B)
    rp_plain = pair_emit.row_popcounts_plain(B)
    check(torch.equal(rp, rp_plain),
          "dense: row_popcounts at the exact plan == plain")
    launches["row_popcounts"] = run["row_popcounts"]
    # Bytes: every mask word read once, one int64 count a row written.
    record("row_popcounts", "collision_tpu_torch/csrc/pair_emit.cu",
           "collision_tpu/kernels/pair_emit.py:426", max_abs_err(rp, rp_plain),
           lambda: pair_emit.row_popcounts(B),
           lambda: pair_emit.row_popcounts_plain(B), nbytes(B, rp), 0,
           plain_batch=1, plain_reps=3)
    del rp_plain
    ws, cb = fill._emit_tables(B, plan.starts.long(),
                               plan.w0.reshape(-1).long(), plan.mc,
                               sweep.NOFF, route["rpw"], rolled=False)
    ids = fill._sorted_ids(plan)
    args = (B, ws, cb, ids, DENSE_CAPACITY, rp)
    got = pair_emit.emit_pair_buffer(*args)
    want = pair_emit.emit_pair_buffer_plain(*args)
    err = max_abs_err(got, want)
    check(got.shape == (DENSE_CAPACITY, 2) and got.is_contiguous(),
          f"dense: pair_emit's buffer {tuple(got.shape)}, contiguous")
    check(torch.equal(got, pairs),
          "dense: pair_emit at the exact plan == the Collider's pairs")
    del got, want, pairs
    launches["pair_emit"] = run["pair_emit"]
    launches["column_plan"] = run["column_plan"]
    plan_phase = column_plan_path(record, coords, radii, route)
    # Bytes: every mask word read once, one 16-byte (a, b) slot written,
    # sentinels included; beside it, the bound of an emission that writes
    # two uint32 ids a pair and no sentinels.
    uint32_bound_ms = bound(nbytes(B) + 8 * int(rp.sum()), 0)[0]
    record("pair_emit", "collision_tpu_torch/csrc/pair_emit.cu",
           "collision_tpu/kernels/pair_emit.py:217", err,
           lambda: pair_emit.emit_pair_buffer(*args),
           lambda: pair_emit.emit_pair_buffer_plain(*args),
           nbytes(B) + 16 * DENSE_CAPACITY, 0, plain_batch=1, plain_reps=1)
    phase("dense_fill", n=DENSE_N, r_max=DENSE_R, capacity=DENSE_CAPACITY,
          count=int(count), count_only=int(count_only), attempts=attempts,
          launches=run, mask_words=B.numel(), mask_window_tests=mask_window,
          mask_culled_tests=mask_culled,
          step_ms=step_ms,
          pair_emit_uint32_bound_ms=uint32_bound_ms,
          exact_attempt_ms=exact_ms, peak_bytes=peak, column_plan=plan_phase,
          seconds=time.perf_counter() - t0)


def dense_oracle(dev):
    """``collide_exact`` on ORACLE_N spheres of the dense radii, above the
    emission threshold, against the k-d tree oracle. Returns the scene on
    the card and the oracle's pairs."""
    from collision_tpu_torch import collide_exact
    from collision_tpu_torch.testing import kdtree_collisions

    t0 = time.perf_counter()
    coords_np, radii_np, coords, radii = uniform_scene(ORACLE_N, dev, DENSE_R)
    res, run = counted(lambda: collide_exact(coords, radii, ORACLE_CAPACITY))
    t1 = time.perf_counter()
    expected = kdtree_collisions(coords_np, radii_np)
    oracle_s = time.perf_counter() - t1
    check(len(expected) > 1 << 21, f"dense_oracle: {len(expected)} pairs > 2^21")
    check(run["pair_emit"] >= 1, f"dense_oracle: pair_emit launched "
          f"{run['pair_emit']}x")
    check_fill(res, expected, f"dense_oracle n={ORACLE_N}")
    phase("dense_oracle", n=ORACLE_N, r_max=DENSE_R,
          capacity=ORACLE_CAPACITY, pairs=len(expected),
          count=int(res.count), ok=bool(res.ok), launches=run,
          oracle_seconds=oracle_s, seconds=time.perf_counter() - t0)
    return coords, radii, expected


def grid_tile_work(bins, gd):
    """(tests, dense_tests, rows), int64[gd^2, tile_pad] in
    ``halo_tile_counts``' layout, from each cell's live rows (xlo below
    +inf; occ of them) and its union box (min lo, max hi over them):

    - ``tests``: what the tile's inputs need, occ * (occ - 1) / 2 for the
      self tile and, for a neighbour tile, the center's rows that meet the
      neighbour's union box times the neighbour's rows that meet the
      center's, as the count kernel culls them;
    - ``dense_tests``: every live pair, occ(a) * occ(b) for a neighbour;
    - ``rows``: the filled rows of its cells, occ(a) + occ(b) or occ.
    """
    import torch
    from collision_tpu_torch import grid
    from collision_tpu_torch.kernels import emit

    inf = float("inf")
    live = bins[..., 0] < inf
    lo, hi = bins[..., 0:3], bins[..., 4:7]
    ulo = torch.where(live[..., None], lo, inf).amin(-2)[..., None, :]
    uhi = torch.where(live[..., None], hi, -inf).amax(-2)[..., None, :]
    occ = live.sum(-1)

    def cells(dx, dy, dz):
        at = (slice(1 + dx, 1 + dx + gd), slice(1 + dy, 1 + dy + gd),
              slice(1 + dz, 1 + dz + gd))
        return live[at], lo[at], hi[at], ulo[at], uhi[at], occ[at]

    def meeting(rows, box):
        """The live rows of cells ``rows`` that meet the union boxes
        ``box``."""
        return (rows[0] & ((rows[2] > box[3]) & (rows[1] < box[4])).all(-1)) \
            .sum(-1)

    c = cells(0, 0, 0)
    self_tests = c[5] * (c[5] - 1) // 2
    tests, dense, rows = [self_tests], [self_tests], [c[5]]
    for d in grid._HALF_OFFSETS:
        b = cells(*d)
        tests.append(meeting(c, b) * meeting(b, c))
        dense.append(c[5] * b[5])
        rows.append(c[5] + b[5])

    def layout(per):
        out = torch.zeros((gd * gd, emit.tile_pad(gd)), dtype=torch.int64,
                          device=bins.device)
        out[:, :14 * gd] = torch.stack(per, -1).reshape(gd * gd, 14 * gd)
        return out

    return layout(tests), layout(dense), layout(rows)


def grid_kernels_agree(bins, gd, mc, label):
    """The grid count kernel against its plain version on one set of
    bins: tile counts, the halo count's total and, at an even grid_dim,
    the batched count's. Returns (max_abs_err, total)."""
    from collision_tpu_torch.kernels import batched, emit, halo

    tc = emit.halo_tile_counts(bins, gd, mc)
    total = int(halo.halo_pairs_plain(bins, gd, mc, 0)[1])
    err = max(max_abs_err(tc, emit.halo_tile_counts_plain(bins, gd, mc)),
              abs(int(tc.sum()) - total),
              abs(int(halo.halo_pairs(bins, gd, mc, 0)[1]) - total))
    if gd % 2 == 0:
        err = max(err, abs(int(batched.batched_count(bins, gd, mc)) - total))
    check(err == 0, f"{label}: grid count kernel == plain (tile counts, "
          f"totals; max_abs_err {err})")
    return err, total


def grid_emit_agrees(bins, gd, mc, label):
    """The grid emission kernel against its plain version on one set of
    bins, bit for bit: fed the hit tiles alone and the fill's own entries
    (with and without the hit count), at room for every pair, inside the
    first tile of two pairs or more, at one slot and at a tile boundary.
    Returns max_abs_err."""
    import torch
    from collision_tpu_torch.kernels import emit

    flat = emit.halo_tile_counts(bins, gd, mc).reshape(-1)
    total = int(flat.sum())
    tiles = torch.nonzero(flat).flatten()
    bases = (torch.cumsum(flat, 0) - flat)[tiles]
    first = int(torch.nonzero(flat[tiles] >= 2)[0])
    err = 0
    for capacity in (total + 64, int(bases[first]) + 1, 1,
                     int(bases[len(tiles) // 2])):
        args = (bins, tiles, bases, gd, mc, capacity)
        want = emit.emit_pairs_plain(*args)
        ft, fb, n_hit = emit.fill_entries(flat, capacity)
        for got in (emit.emit_pairs(*args),
                    emit.emit_pairs(bins, ft, fb, gd, mc, capacity,
                                    n_hit=n_hit),
                    emit.emit_pairs(bins, ft, fb, gd, mc, capacity)):
            err = max(err, max_abs_err(got, want))
    check(err == 0, f"{label}: grid emission kernel == plain, hit tiles and "
          f"fill entries, 4 capacities (max_abs_err {err})")
    return err


def big_kernels_agree(bigs, stream, label):
    """The big count kernel against its plain version on one table and
    stream: the total, the row counts, and big_pairs' buffers at room
    for every pair, cut inside the pairs and at one slot. Returns
    (max_abs_err, total)."""
    import torch
    from collision_tpu_torch.kernels import bigpass

    tot, ok = bigpass.big_count_only(bigs, stream)
    total, plain_ok = bigpass.big_count_only_plain(bigs, stream)
    check(bool(ok) == bool(plain_ok), f"{label}: big_count: no_overflow == "
          "plain")
    total = int(total)
    got, want = big_row_counts(bigs, stream)
    err = max(abs(int(tot) - total), max_abs_err(got, want))
    same = True
    for capacity in (total + 64, total // 2 + 1, 1):
        a = bigpass.big_pairs(bigs, stream, capacity)
        b = bigpass.big_pairs_plain(bigs, stream, capacity)
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
    check(err == 0 and same, f"{label}: big count kernel == plain (total, "
          f"row counts; max_abs_err {err}), big_pairs' buffers bit for bit")
    return err if same else max(err, 1), total


def slab_kernels_agree(plan, label):
    """The slab count kernel at first offsets 0 and 1 and dmin 0 and 48,
    and the slab masks kernel, at one and two rolled rows, against their
    plain versions on one slab plan. Returns (max_abs_err, nonzero mask
    words)."""
    from collision_tpu_torch.kernels import slab_sweep

    args = (plan.stream, plan.starts, plan.w0, plan.wcap)
    err = words = 0
    for rpw in (1, 2):
        for first_off in (0, 1):
            for dmin in (0, DIAG_D_MAX):
                kw = {"rpw": rpw, "first_off": first_off, "dmin": dmin}
                err = max(err, abs(
                    int(slab_sweep.slab_window_count(*args, **kw))
                    - int(slab_sweep.slab_window_count_plain(*args, **kw))))
        got = slab_sweep.slab_masks(*args, rpw=rpw)
        err = max(err, max_abs_err(
            got, slab_sweep.slab_masks_plain(*args, rpw=rpw)))
        words += int(got.ne(0).sum())
    check(err == 0, f"{label}: slab count and masks kernels == plain "
          f"(max_abs_err {err})")
    return err, words


def cull_edges(dev):
    """The grid count, column masks, slab count and masks and big pass
    kernels against their plain versions at the edges of their cull
    (collision_tpu_torch/testing/scenes.py: boxes touching across cell,
    column or slab faces and one ulp across, radii of half a cell, a
    305-row cell beside an empty one, a full column or slab beside an
    empty one, chunks that end inside a mask word, windows from odd
    positions and from a stream row's last lane, and the slab scenes'
    tables shifted by 1 and 65 lanes; bigs on the faces of the rows'
    union boxes, a row of pad lanes, a row of parked lanes) and on the
    dense oracle scene's grid (65536 spheres, radii U(0, 0.06), grid_dim
    8, cell_capacity 192: two 128-row chunks, a cull that keeps most
    rows)."""
    import torch
    from collision_tpu_torch import columns, grid, slabs
    from collision_tpu_torch.kernels import sweep
    from collision_tpu_torch.testing.scenes import (COLUMN_SCENES,
                                                    GRID_SCENES, SLAB_EDGES,
                                                    SLAB_SCENES, slab_edges,
                                                    touching_big_pass)

    t0 = time.perf_counter()
    totals = {}
    for name, scene in GRID_SCENES.items():
        coords, radii, gd, mc = scene()
        bins, ok, _ = grid.build_grid(torch.from_numpy(coords).to(dev),
                                      torch.from_numpy(radii).to(dev), gd, mc)
        check(bool(ok), f"{name}: bins ok")
        totals[name] = grid_kernels_agree(bins, gd, mc, name)[1]
        grid_emit_agrees(bins, gd, mc, name)
    _, _, coords, radii = uniform_scene(ORACLE_N, dev, DENSE_R)
    bins, ok, _ = grid.build_grid(coords, radii, *DENSE_GRID)
    check(bool(ok), f"dense grid {DENSE_GRID}: bins ok")
    totals["dense_grid"] = grid_kernels_agree(bins, *DENSE_GRID,
                                              "dense grid")[1]
    grid_emit_agrees(bins, *DENSE_GRID, "dense grid")
    for name, scene in COLUMN_SCENES.items():
        coords, radii, gxy, cap = scene()
        gxy, default_cap, rows = columns.default_column_config(len(coords),
                                                               gxy=gxy)
        plan = columns.plan_columns(torch.from_numpy(coords).to(dev),
                                    torch.from_numpy(radii).to(dev), gxy,
                                    cap or default_cap, rows)
        check(bool(plan.ok), f"{name}: column plan ok")
        words = 0
        for rpw in (1, int(plan.rows_needed)):
            got = sweep.sweep_masks(plan, rpw)
            err = max_abs_err(got, sweep.sweep_masks_plain(plan, rpw))
            check(err == 0, f"{name}: column masks kernel == plain at rpw "
                  f"{rpw} (max_abs_err {err})")
            words = int(got.ne(0).sum())
        totals[name + "_mask_words"] = words
    for name, scene in SLAB_SCENES.items():
        coords, radii, gx, cap = scene()
        gx, default_cap, rows = slabs.default_slab_config(len(coords), gx=gx)
        plan = slabs.plan_slabs(torch.from_numpy(coords).to(dev),
                                torch.from_numpy(radii).to(dev), gx,
                                cap or default_cap, rows)
        edges = slab_edges(*(t.cpu().numpy() for t in (
            plan.stream, plan.starts, plan.w0, plan.wcap)), gx)
        check(bool(plan.ok) and SLAB_EDGES[name] <= edges,
              f"{name}: slab plan ok, reaches {sorted(SLAB_EDGES[name])}")
        totals["slab_" + name + "_mask_words"] = slab_kernels_agree(
            plan, f"slab {name}")[1]
        npos = plan.stream.shape[0] * 128
        for shift in (1, 65):
            w0 = plan.w0 + shift
            slab_kernels_agree(plan._replace(w0=w0, wcap=torch.minimum(
                plan.wcap, npos - w0).clamp(min=0)),
                f"slab {name} shifted {shift}")
    *table, stream = touching_big_pass()
    bigs = tuple(torch.from_numpy(a).to(dev) for a in table)
    totals["touching_big_pass"] = big_kernels_agree(
        bigs, torch.from_numpy(stream).to(dev), "touching_big_pass")[1]
    phase("cull_edges", totals=totals, seconds=time.perf_counter() - t0)


def grid_path(dev, record, launches, coords, radii, expected, dense):
    """The grid engine at N spheres: launches, oracle and plain path of
    its count and fill, the odd-grid count, the halo emission against the
    split fill, the overflow and the Collider's retry on the dense oracle
    scene (``dense``: coords, radii, oracle pairs), the four kernels'
    records and the step times."""
    import torch
    from collision_tpu_torch import Collider, collide, grid
    from collision_tpu_torch.kernels import batched, emit, grid_bins, halo

    t0 = time.perf_counter()
    gd, mc = GRID_CONFIG
    (res_count, res_fill), run = counted(lambda: (
        collide(coords, radii, 0, method="grid"),
        collide(coords, radii, CAPACITY, method="grid")))
    for kernel, ran in run.items():
        check((ran > 0) == (kernel in GRID_KERNELS),
              f"grid: {kernel} launched {ran}x")
    check_count(res_count, expected, "grid")
    check_fill(res_fill, expected, "grid")
    with plain_kernels():
        plain_count = collide(coords, radii, 0, method="grid")
        plain_fill = collide(coords, radii, CAPACITY, method="grid")
    check(int(plain_count.count) == int(res_count.count)
          and bool(plain_count.ok), "grid count == plain path's count")
    check(torch.equal(plain_fill.pairs, res_fill.pairs),
          "grid fill pairs == plain path's pairs, bit for bit")
    for name in GRID_KERNELS[:2] + GRID_KERNELS[3:]:
        launches[name] = run[name]

    odd, odd_run = counted(lambda: collide(
        coords, radii, 0, method="grid", grid_dim=GRID_ODD, cell_capacity=mc))
    check(odd_run["halo_count"] == 1 and odd_run["batched_count"] == 0,
          f"grid_dim {GRID_ODD}: halo_count launched {odd_run['halo_count']}x")
    check_count(odd, expected, f"grid_dim {GRID_ODD}")
    launches["halo_count"] = odd_run["halo_count"]

    bins = grid.build_grid(coords, radii, gd, mc)[0]
    for capacity in (CAPACITY, TRUNC_CAPACITY):
        hp, hp_total = halo.halo_pairs(bins, gd, mc, capacity)
        gf, gf_total = emit.grid_fill(bins, gd, mc, capacity)
        check(torch.equal(hp, gf) and int(hp_total) == int(gf_total)
              == len(expected),
              f"halo_pairs capacity {capacity} == grid_fill, true total")
    over = collide(coords, radii, 0, method="grid",
                   cell_capacity=GRID_OVERFLOW_CAPACITY)
    check(not bool(over.ok),
          f"grid cell_capacity {GRID_OVERFLOW_CAPACITY}: ok=False")
    d_coords, d_radii, d_expected = dense
    d_first = collide(d_coords, d_radii, 0, method="grid")
    d_count, d_run = counted(lambda: Collider(
        ORACLE_N, method="grid").get_collisions(d_coords, d_radii, 0,
                                                collisions=None))
    check(not bool(d_first.ok) and int(d_count) == len(d_expected),
          f"Collider(method='grid') n={ORACLE_N}: grid attempt not ok, retry "
          f"count {int(d_count)} == oracle")

    # --- the bins chain against the plain path, bit for bit ---
    # (bytes: centres and radii read once, bins and ids written once; the
    # sort's digit passes, each reading and writing the 32-bit keys and
    # ids, beside them as sort_bytes)
    want = grid.build_grid_plain(coords, radii, gd, mc)
    got = grid_bins.build_bins(coords, radii, gd, mc)
    bins_err = max(max_abs_err(got[0].view(torch.int32),
                               want[0].view(torch.int32)),
                   max_abs_err(got[2], want[2]),
                   int(bool(got[1]) != bool(want[1])))
    sort_bytes = 16 * N * -(-((gd ** 3 - 1).bit_length()) // 8)
    record("grid_bins", "collision_tpu_torch/csrc/grid_bins.cu",
           "none (XLA ops: collision_tpu/grid.py build_grid)", bins_err,
           lambda: grid_bins.build_bins(coords, radii, gd, mc),
           lambda: grid.build_grid_plain(coords, radii, gd, mc),
           nbytes(coords, radii, got[0], got[2]), 0,
           extra={"sort_bytes": sort_bytes,
                  "bound_with_sort_ms": bound(nbytes(coords, radii, got[0],
                                                     got[2]) + sort_bytes,
                                              0)[0]})
    del want, got

    # --- the four kernels against their plain versions at N's bins ---
    # (tile counts and totals at both grid_dims, the count kernel's tests
    # as its cull needs them, the live tests beside them)
    bins_odd = grid.build_grid(coords, radii, GRID_ODD, mc)[0]
    tests, dense_tests, rows = grid_tile_work(bins, gd)
    tests_odd, dense_odd = (int(t.sum())
                            for t in grid_tile_work(bins_odd, GRID_ODD)[:2])
    err_odd = grid_kernels_agree(bins_odd, GRID_ODD, mc,
                                 f"grid_dim {GRID_ODD}")[0]
    err = grid_kernels_agree(bins, gd, mc, f"grid_dim {gd}")[0]
    record("halo_count", "collision_tpu_torch/csrc/grid.cu",
           "collision_tpu/kernels/halo.py:39", err_odd,
           lambda: halo.halo_pairs(bins_odd, GRID_ODD, mc, 0),
           lambda: halo.halo_pairs_plain(bins_odd, GRID_ODD, mc, 0),
           nbytes(bins_odd) + 8, tests_odd, plain_batch=2,
           dense_tests=dense_odd)
    record("batched_count", "collision_tpu_torch/csrc/grid.cu",
           "collision_tpu/kernels/batched.py:23", err,
           lambda: batched.batched_count(bins, gd, mc),
           lambda: batched.batched_count_plain(bins, gd, mc),
           nbytes(bins) + 8, int(tests.sum()), plain_batch=2,
           dense_tests=int(dense_tests.sum()))
    tc = emit.halo_tile_counts(bins, gd, mc)
    record("grid_tile_counts", "collision_tpu_torch/csrc/grid.cu",
           "collision_tpu/kernels/emit.py:55", err,
           lambda: emit.halo_tile_counts(bins, gd, mc),
           lambda: emit.halo_tile_counts_plain(bins, gd, mc),
           nbytes(bins, tc), int(tests.sum()), plain_batch=2,
           dense_tests=int(dense_tests.sum()))
    flat = tc.reshape(-1)
    tiles = torch.nonzero(flat).flatten()
    bases = (torch.cumsum(flat, 0) - flat)[tiles]
    args = (bins, tiles, bases, gd, mc, CAPACITY)
    got = emit.emit_pairs(*args)
    check(torch.equal(got, res_fill.pairs), "emit_pairs == the grid fill")
    # The fill's own launch: every entry of the compacted hit list
    # (min(CAPACITY, tiles) of them) and the hit count on the card.
    ft, fb, n_hit = emit.fill_entries(flat, CAPACITY)
    fargs = (bins, ft, fb, gd, mc, CAPACITY)
    fgot = emit.emit_pairs(*fargs, n_hit=n_hit)
    check(torch.equal(fgot, res_fill.pairs),
          "emit_pairs on the fill's entries and hit count == the grid fill")
    # Bytes: the hit tiles' filled rows (32 bytes each), their entries, the
    # hit count and the [CAPACITY, 2] uint32 buffer written once.
    record("grid_emit", "collision_tpu_torch/csrc/grid.cu",
           "collision_tpu/kernels/emit.py:135",
           max(max_abs_err(got, emit.emit_pairs_plain(*args)),
               max_abs_err(fgot, emit.emit_pairs_plain(*fargs, n_hit=n_hit))),
           lambda: emit.emit_pairs(*fargs, n_hit=n_hit),
           lambda: emit.emit_pairs_plain(*fargs, n_hit=n_hit),
           32 * int(rows.reshape(-1)[tiles].sum()) + nbytes(tiles, bases)
           + 8 + 8 * CAPACITY, int(tests.reshape(-1)[tiles].sum()),
           plain_batch=1, plain_reps=3,
           dense_tests=int(dense_tests.reshape(-1)[tiles].sum()),
           extra={"entries": ft.numel(), "hit_tiles": int(n_hit),
                  "hit_tiles_ms": time_ms(lambda: emit.emit_pairs(*args),
                                          batch=KERNEL_BATCH)})

    # halo_pairs' count on the default bins: the kernel batched_count
    # launches, through the other wrapper.
    steps = {"halo_count_gd24_ms": time_ms(
        lambda: halo.halo_pairs(bins, gd, mc, 0), batch=KERNEL_BATCH)}
    for label, capacity in (("count_step", 0), ("fill_step", CAPACITY)):
        steps[label + "_ms"] = time_ms(
            lambda: collide(coords, radii, capacity, method="grid"))
        with plain_kernels():
            steps[label + "_plain_ms"] = time_ms(
                lambda: collide(coords, radii, capacity, method="grid"),
                reps=5)
    phase("grid", n=N, grid_dim=gd, cell_capacity=mc,
          count=int(res_count.count), ok=bool(res_count.ok),
          fill_total=int(res_fill.count), fill_ok=bool(res_fill.ok),
          launches=run, odd_launches=odd_run, tests=int(tests.sum()),
          dense_tests=int(dense_tests.sum()), tests_odd=tests_odd,
          dense_tests_odd=dense_odd, hit_tiles=tiles.numel(),
          hit_tile_tests=int(tests.reshape(-1)[tiles].sum()),
          max_occupancy=int(torch.isfinite(bins[..., 0]).sum(-1).max()),
          overflow_ok=bool(over.ok), dense_first_ok=bool(d_first.ok),
          dense_count=int(d_count), dense_launches=d_run, **steps,
          seconds=time.perf_counter() - t0)


def diag_path(dev, record, launches, coords, radii, expected):
    """The diagonal count on the main path's scene: its launches, the
    oracle, the flagging scene, the kernel's record and the step times
    beside the dual dispatch's."""
    import torch
    from collision_tpu_torch import slabs
    from collision_tpu_torch.kernels import slab_sweep
    from collision_tpu_torch.testing import kdtree_collisions

    t0 = time.perf_counter()
    config = slabs.default_slab_config(N)

    def diag_step():
        plan = slabs.plan_slabs(coords, radii, *config)
        return plan, slab_sweep.slab_count_diag(plan, DIAG_D_MAX)

    (plan, (count, ok)), run = counted(diag_step)
    for kernel, ran in run.items():
        check(ran == (kernel in ("diag_count", "slab_count", "slab_plan")),
              f"diag: {kernel} launched {ran}x")
    check(bool(plan.ok) and bool(ok), "diag: plan ok and count ok")
    check(int(count) == len(expected),
          f"diag: count {int(count)} == oracle {len(expected)}")

    # The same-z cluster: partners at any sorted distance.
    n_f, seed_f, r_f, d_f = FLAG_SCENE
    rng = np.random.RandomState(seed_f)
    fc_np = rng.random((n_f, 3)).astype("float32")
    fc_np[:, 2] = 0.5
    fr_np = np.full(n_f, r_f, "float32")
    fplan = slabs.plan_slabs(torch.from_numpy(fc_np).to(dev),
                             torch.from_numpy(fr_np).to(dev),
                             *slabs.default_slab_config(n_f))
    f_expected = kdtree_collisions(fc_np, fr_np)
    fcount, fok = slab_sweep.slab_count_diag(fplan, d_f)
    fflag = slab_sweep.diag_count(fplan.stream, fplan.diag_thr, d_f)[1]
    dual, dual_ok = slab_sweep.slab_count_dual(fplan)
    check(not bool(fok) and int(fflag) > 0
          and int(fcount) <= len(f_expected),
          f"diag same-z cluster: flagged {int(fflag)}, ok=False, count "
          f"{int(fcount)} <= {len(f_expected)}")
    check(bool(dual_ok) and int(dual) == len(f_expected),
          f"diag same-z cluster: slab_count_dual {int(dual)} == oracle")

    # The kernel against its plain version at the main path's plan.
    dargs = (plan.stream, plan.diag_thr, DIAG_D_MAX)
    got = slab_sweep.diag_count(*dargs)
    want = slab_sweep.diag_count_plain(*dargs)
    err = max(abs(int(got[0]) - int(want[0])), abs(int(got[1]) - int(want[1])))
    launches["diag_count"] = run["diag_count"]
    # Box tests the scene needs: each live sphere against the next
    # DIAG_D_MAX live ones.
    tests = N * DIAG_D_MAX - DIAG_D_MAX * (DIAG_D_MAX + 1) // 2
    # Bytes it needs: channels 0-5 and 7 (float32) of the N live positions
    # and the d_max + 1 after them (the id channel and the +inf pad rows
    # are never needed), diag_thr, and the two int64 counts out.
    moved = 7 * 4 * (N + DIAG_D_MAX + 1) + nbytes(plan.diag_thr) + 16
    # Beside them, the tests the kernel runs: every position of its domain,
    # pads included, against the next DIAG_D_MAX.
    domain = slab_sweep._diag_positions(plan.stream, DIAG_D_MAX)
    record("diag_count", "collision_tpu_torch/csrc/slab_sweep.cu",
           "collision_tpu/kernels/slab_sweep.py:43", err,
           lambda: slab_sweep.diag_count(*dargs),
           lambda: slab_sweep.diag_count_plain(*dargs),
           moved, tests, plain_batch=2, dense_tests=domain * DIAG_D_MAX,
           extra={"bound": bounds(moved, tests)})
    # The cross-only slab count that slab_count_diag launches (offset x+1,
    # j > i + d_max): the tests its per-word cull leaves.
    cross, cross_window = mask_tests(plan, 1, True, noff=2, first_off=1,
                                     dmin=DIAG_D_MAX)
    cross_bound = bounds(sweep_bytes(plan) + 8, cross)

    steps = {
        "diag_step_ms": time_ms(lambda: slab_sweep.slab_count_diag(
            slabs.plan_slabs(coords, radii, *config), DIAG_D_MAX)),
        "dual_step_ms": time_ms(lambda: slab_sweep.slab_count_dual(
            slabs.plan_slabs(coords, radii, *config))),
        "diag_count_ms": time_ms(lambda: slab_sweep.slab_count_diag(
            plan, DIAG_D_MAX)),
        "dual_count_ms": time_ms(lambda: slab_sweep.slab_count_dual(plan)),
    }
    phase("diag", n=N, d_max=DIAG_D_MAX, gx=plan.gx, count=int(count),
          ok=bool(ok), diagonal=int(got[0]), flagged=int(got[1]),
          launches=run, box_tests=tests,
          cross_only={"tests": cross, "dense_tests": cross_window,
                      **cross_bound}, flag_scene_n=n_f,
          flag_scene_flagged=int(fflag), flag_scene_count=int(fcount),
          flag_scene_pairs=len(f_expected), **steps,
          seconds=time.perf_counter() - t0)


def float64_path(dev, coords_np, radii_np):
    """Float64 steps at N through ``auto`` and ``"column"`` (the
    run-expansion fill: no kernel launches), against a float64 oracle,
    with times; and the float64 Collider's candidate retry."""
    import torch
    from collision_tpu_torch import Collider, collide
    from collision_tpu_torch.testing import kdtree_collisions

    t0 = time.perf_counter()
    c64_np, r64_np = coords_np.astype("float64"), radii_np.astype("float64")
    c64 = torch.from_numpy(c64_np).to(dev)
    r64 = torch.from_numpy(r64_np).to(dev)
    cases = [(m, cap) for m in ("auto", "column") for cap in (0, F64_CAPACITY)]
    results, run = counted(lambda: [collide(c64, r64, cap, method=m)
                                    for m, cap in cases])
    check(not any(run.values()), f"float64: no kernel launched ({run})")
    t1 = time.perf_counter()
    expected = kdtree_collisions(c64_np, r64_np)
    oracle_s = time.perf_counter() - t1
    for (method, cap), res in zip(cases, results):
        label = f"float64 {method} n={N}"
        if cap:
            check_fill(res, expected, label)
        else:
            check_count(res, expected, label)
    check(torch.equal(results[1].pairs, results[3].pairs),
          "float64: auto fill == column fill, bit for bit")
    steps = {f"{m}_{'fill' if cap else 'count'}_ms": time_ms(
        lambda m=m, cap=cap: collide(c64, r64, cap, method=m), reps=5)
        for m, cap in cases}

    coords0 = np.zeros((F64_RETRY_N, 3))
    radii0 = np.full(F64_RETRY_N, F64_RETRY_R)
    first = collide(torch.from_numpy(coords0).to(dev),
                    torch.from_numpy(radii0).to(dev), F64_RETRY_N)
    count, pairs = Collider(F64_RETRY_N, coord_dtype="float64").get_collisions(
        coords0, radii0, F64_RETRY_N)
    cpu = Collider(F64_RETRY_N, coord_dtype="float64",
                   device="cpu").get_collisions(coords0, radii0, F64_RETRY_N)
    all_pairs = F64_RETRY_N * (F64_RETRY_N - 1) // 2
    check(not bool(first.ok) and int(count) == all_pairs,
          f"float64 Collider({F64_RETRY_N}): first step not ok, retry count "
          f"{int(count)} == {all_pairs}")
    check(torch.equal(pairs.cpu(), cpu[1]),
          f"float64 Collider({F64_RETRY_N}): pairs == the CPU run's")
    phase("float64", n=N, capacity=F64_CAPACITY, pairs=len(expected),
          counts=[int(res.count) for res in results],
          oks=[bool(res.ok) for res in results], launches=run,
          oracle_seconds=oracle_s, retry_count=int(count), **steps,
          seconds=time.perf_counter() - t0)


def slab_plan_path(dev, record, coords, radii):
    """The slab plan chain against its plain path, bit for bit, and both
    timed: its record at N's default plan, and the benchmark's 16M plan
    at gx 1000 (``slab_plan_16m``). The bound's bytes: centres and radii
    read once, the stream and tables written once; the sort's four digit
    passes, each reading and writing the 32-bit keys and ids, beside them
    (``sort_bytes``), and the keys, ids and packed records written and
    read once (``scratch_bytes``)."""
    import torch
    from collision_tpu_torch import slabs
    from collision_tpu_torch.kernels import slab_plan
    from collision_tpu_torch.testing.scenes import plan_mismatches

    def work(c, r, plan):
        n = c.shape[0]
        moved = nbytes(c, r, plan.stream, plan.starts, plan.w0, plan.wcap)
        sort_bytes = 16 * n * -(-(slabs._xbits_z(plan.gx)
                                  + (plan.gx - 1).bit_length()) // 8)
        return moved, {"sort_bytes": sort_bytes, "scratch_bytes": 48 * n,
                       "bound_with_sort_ms": bound(moved + sort_bytes, 0)[0]}

    config = slabs.default_slab_config(coords.shape[0])
    got = slab_plan.build_plan(coords, radii, *config)
    bad = plan_mismatches(got, slabs.plan_slabs_plain(coords, radii,
                                                           *config))
    check(bad == [], f"slab_plan n={coords.shape[0]}: every field == plain "
          f"path's ({bad})")
    moved, extra = work(coords, radii, got)
    record("slab_plan", "collision_tpu_torch/csrc/slab_plan.cu",
           "none (XLA ops: collision_tpu/slabs.py plan_slabs)", len(bad),
           lambda: slab_plan.build_plan(coords, radii, *config),
           lambda: slabs.plan_slabs_plain(coords, radii, *config), moved, 0,
           extra=extra)
    del got

    t0 = time.perf_counter()
    n, gx = PLAN_16M
    _, _, c, r = uniform_scene(n, dev)
    config = slabs.default_slab_config(n, gx=gx)
    got = slab_plan.build_plan(c, r, *config)
    bad = plan_mismatches(got, slabs.plan_slabs_plain(c, r, *config))
    check(bad == [], f"slab_plan n={n} gx={gx}: every field == plain path's "
          f"({bad})")
    moved, extra = work(c, r, got)
    del got
    torch.cuda.synchronize()
    phase("slab_plan_16m", n=n, gx=gx, ok=not bad,
          ms=time_ms(lambda: slab_plan.build_plan(c, r, *config),
                     batch=KERNEL_BATCH),
          closed_loop_ms=time_ms(lambda: slab_plan.build_plan(c, r, *config)),
          plain_ms=time_ms(lambda: slabs.plan_slabs_plain(c, r, *config),
                           reps=5),
          bound_ms=bound(moved, 0)[0], **extra,
          seconds=time.perf_counter() - t0)


def column_plan_path(record, coords, radii, route):
    """The column plan chain against its plain path, bit for bit, on the
    dense scene: its record at the exact knobs (``route``: gxy,
    col_capacity, slab_rows), and at the default knobs, where the plan
    says ok=False, its times and statistics. The bound's bytes: centres
    and radii read once, the stream, starts and tables written once; the
    sort's digit passes, each reading and writing the 32-bit keys and
    ids, beside them (``sort_bytes``), and the keys, ids and packed
    records written and read once (``scratch_bytes``). Returns the
    default knobs' fields."""
    from collision_tpu_torch import columns
    from collision_tpu_torch.kernels import column_plan
    from collision_tpu_torch.testing.scenes import plan_mismatches

    def work(c, r, plan):
        n = c.shape[0]
        moved = nbytes(c, r, plan.stream, plan.starts, plan.w0, plan.wcap)
        sort_bytes = 16 * n * -(-(columns._zbits(plan.gxy)
                                  + (plan.gxy ** 2 - 1).bit_length()) // 8)
        return moved, {"sort_bytes": sort_bytes, "scratch_bytes": 48 * n,
                       "bound_with_sort_ms": bound(moved + sort_bytes, 0)[0]}

    default = columns.default_column_config(coords.shape[0])
    exact = (route["gxy"], route["col_capacity"], route["slab_rows"])
    fields = {}
    for label, config in (("default", default), ("exact", exact)):
        got = column_plan.build_plan(coords, radii, *config)
        want = columns.plan_columns_plain(coords, radii, *config)
        bad = plan_mismatches(got, want)
        check(bad == [], f"column_plan {label} {config}: every field == "
              f"plain path's ({bad})")
        moved, extra = work(coords, radii, got)
        fields[label] = {"config": config, "ok": bool(got.ok),
                         "max_col": int(got.max_col),
                         "max_slab_rows": int(got.max_slab_rows),
                         "rows_needed": int(got.rows_needed),
                         "rows_rolled": int(got.rows_rolled)}
        del got, want
        if label == "exact":
            record("column_plan", "collision_tpu_torch/csrc/column_plan.cu",
                   "none (XLA ops: collision_tpu/columns.py plan_columns)",
                   len(bad),
                   lambda: column_plan.build_plan(coords, radii, *config),
                   lambda: columns.plan_columns_plain(coords, radii, *config),
                   moved, 0, extra={**extra, "closed_loop_ms": time_ms(
                       lambda: column_plan.build_plan(coords, radii,
                                                      *config))})
        else:
            fields[label].update(
                ms=time_ms(lambda: column_plan.build_plan(coords, radii,
                                                          *config),
                           batch=KERNEL_BATCH),
                closed_loop_ms=time_ms(
                    lambda: column_plan.build_plan(coords, radii, *config)),
                plain_ms=time_ms(
                    lambda: columns.plan_columns_plain(coords, radii,
                                                       *config)),
                bound_ms=bound(moved, 0)[0], **extra)
    return fields


def counted(fn):
    """(result of ``fn()``, launches per kernel during it): the counters
    are reset just before and read after the card has finished."""
    import torch
    from collision_tpu_torch import tracing

    tracing.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(tracing.LAUNCHES)


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

    from collision_tpu_torch import collide, columns, hetero, slabs
    from collision_tpu_torch.kernels import (_build, bigpass, compact,
                                             slab_sweep, sweep)
    from collision_tpu_torch.testing import kdtree_collisions, pair_array_to_set

    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    phase("build", seconds=build_s, ptxas=[
        line.split("ptxas info    : ")[-1] for line in report.splitlines()
        if "Used" in line or "spill" in line or "Compiling entry" in line])

    dev = torch.device("cuda")
    coords_np, radii_np, coords, radii = uniform_scene(N, dev)

    # --- the slab engine's main path, counted ---
    (res_count, res_fill), slab_launches = counted(lambda: (
        collide(coords, radii, 0, method="slab"),
        collide(coords, radii, CAPACITY, method="slab")))
    phase("main_path", n=N, capacity=CAPACITY, count=int(res_count.count),
          ok=bool(res_count.ok), fill_total=int(res_fill.count),
          fill_ok=bool(res_fill.ok), launches=slab_launches)
    for name in SLAB_KERNELS:
        check(slab_launches[name] > 0,
              f"main path launched {name} ({slab_launches[name]}x)")

    # --- end to end against the oracle and the plain path ---
    t0 = time.perf_counter()
    expected = kdtree_collisions(coords_np, radii_np)
    phase("oracle", pairs=len(expected), seconds=time.perf_counter() - t0)
    check_against_oracle(res_count, res_fill, expected, f"n={N}")
    with plain_kernels():
        (plain_count, plain_fill), plain_run = counted(lambda: (
            collide(coords, radii, 0, method="slab"),
            collide(coords, radii, CAPACITY, method="slab")))
    check(not any(plain_run.values()),
          f"plain path: every kernel swapped, none launched ({plain_run})")
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

    launches = dict(slab_launches)

    def record(name, source, replaces, err, fn, plain_fn, moved, tests,
               library_fn=None, plain_batch=KERNEL_BATCH, plain_reps=10,
               dense_tests=None, extra=None):
        check(err == 0, f"{name}: kernel == plain (max_abs_err {err})")
        bound_ms, bound_by = bound(moved, tests)
        extra = dict(extra or {})
        if dense_tests is not None:
            extra.update(tests=tests, dense_tests=dense_tests)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": time_ms(fn, batch=KERNEL_BATCH),
            "plain_ms": time_ms(plain_fn, warmup=min(2, plain_reps),
                                reps=plain_reps, batch=plain_batch),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library_fn is None
            else time_ms(library_fn, batch=KERNEL_BATCH), **extra})

    # Rows 1-2's bounds: the tests the kernels' per-word union-box cull
    # leaves on the slab plan (every window test beside them as
    # dense_tests).
    sweep_in = sweep_bytes(plan)
    slab_tests, slab_window = mask_tests(plan, 1, True, noff=2)
    cnt = slab_sweep.slab_window_count(*args)
    record("slab_count", "collision_tpu_torch/csrc/slab_sweep.cu",
           "collision_tpu/kernels/slab_sweep.py:157",
           abs(int(cnt) - int(slab_sweep.slab_window_count_plain(*args))),
           lambda: slab_sweep.slab_window_count(*args),
           lambda: slab_sweep.slab_window_count_plain(*args), sweep_in + 8,
           slab_tests, dense_tests=slab_window,
           extra={"bound": bounds(sweep_in + 8, slab_tests)})
    masks = slab_sweep.slab_masks(*args)
    plain_masks = slab_sweep.slab_masks_plain(*args)
    check(torch.equal(masks, plain_masks), "slab_masks: torch.equal")
    record("slab_masks", "collision_tpu_torch/csrc/slab_sweep.cu",
           "collision_tpu/kernels/slab_sweep.py:347",
           max_abs_err(masks, plain_masks),
           lambda: slab_sweep.slab_masks(*args),
           lambda: slab_sweep.slab_masks_plain(*args),
           sweep_in + nbytes(masks), slab_tests, dense_tests=slab_window,
           extra={"bound": bounds(sweep_in + nbytes(masks), slab_tests)})
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
           lambda: compact.compact_mask_plain(small, slabs.RESIDUAL_PAIRS),
           nbytes(small) + 8 * (slabs.RESIDUAL_PAIRS + 1), 0,
           library_fn=lambda: torch.nonzero(small))

    slab_plan_path(dev, record, coords, radii)

    # --- step times, kernel path and plain path ---
    steps = {}
    for label, capacity in (("count_step", 0), ("fill_step", CAPACITY)):
        steps[label + "_ms"] = time_ms(
            lambda: collide(coords, radii, capacity, method="slab"))
        with plain_kernels():
            steps[label + "_plain_ms"] = time_ms(
                lambda: collide(coords, radii, capacity, method="slab"))
    phase("steps", n=N, **steps)
    diag_path(dev, record, launches, coords, radii, expected)

    # --- the column engine's main path at 1M, counted ---
    gxy, ccap, crows = columns.default_column_config(N)

    def column_path():
        count = collide(coords, radii, 0, method="column")
        fill = collide(coords, radii, CAPACITY, method="column")
        # The public count entry point at its default (aligned rows).
        plan = columns.plan_columns(coords, radii, gxy, ccap, crows)
        return count, fill, plan, sweep.sweep_count(plan)

    (col_count, col_fill, cplan, public_count), col_launches = counted(
        column_path)
    phase("column_main_path", n=N, capacity=CAPACITY, gxy=gxy,
          col_capacity=ccap, slab_rows=crows, count=int(col_count.count),
          ok=bool(col_count.ok), fill_total=int(col_fill.count),
          fill_ok=bool(col_fill.ok), public_sweep_count=int(public_count),
          rows_needed=int(cplan.rows_needed),
          rows_rolled=int(cplan.rows_rolled), launches=col_launches)
    for name in COLUMN_KERNELS:
        check(col_launches[name] > 0,
              f"column path launched {name} ({col_launches[name]}x)")
        launches[name] = col_launches[name]
    check_against_oracle(col_count, col_fill, expected, f"column n={N}")
    check(int(col_count.count) == int(res_count.count),
          "column count == slab count")
    check(bool(cplan.ok) and int(cplan.rows_needed) <= 2
          and int(public_count) == len(expected),
          "sweep_count(plan) at aligned rows == oracle")
    with plain_kernels():
        plain_col_count = collide(coords, radii, 0, method="column")
        plain_col_fill = collide(coords, radii, CAPACITY, method="column")
    check(int(plain_col_count.count) == int(col_count.count),
          "column count == plain path's count")
    check(torch.equal(plain_col_fill.pairs, col_fill.pairs),
          "column fill pairs == plain path's pairs, bit for bit")
    # The count kernels' records: the column engine's 1M plan, where the
    # main path runs the rolled one.
    work = column_plan_work(cplan, 2, f"column n={N}", 2)
    col_in = sweep_bytes(cplan)
    for rolled, name, line in ((True, "sweep_count_rolled", 226),
                               (False, "sweep_count_aligned", 78)):
        w = work["count_rolled" if rolled else "count_aligned"]
        record(name, "collision_tpu_torch/csrc/sweep.cu",
               f"collision_tpu/kernels/sweep.py:{line}", w["max_abs_err"],
               lambda: sweep.sweep_count(cplan, 2, rolled),
               lambda: sweep.sweep_count_plain(cplan, 2, rolled), col_in + 8,
               w["tests"], plain_batch=2, dense_tests=w["dense_tests"])

    # --- auto below the slab crossovers ---
    auto_scenes = {}
    for n_auto, capacities in AUTO_SCENES:
        a_np, ar_np, a, ar = uniform_scene(n_auto, dev)
        a_expected = kdtree_collisions(a_np, ar_np)
        auto_scenes[n_auto] = (a, ar)
        results, auto_launches = counted(
            lambda: [collide(a, ar, cap) for cap in capacities])
        phase("auto", n=n_auto, capacities=capacities, pairs=len(a_expected),
              counts=[int(res.count) for res in results],
              oks=[bool(res.ok) for res in results], launches=auto_launches)
        want = {"sweep_count_rolled": 0 in capacities,
                "sweep_masks": any(capacities),
                "row_popcounts": any(capacities), "column_plan": True}
        for name, ran in auto_launches.items():
            check((ran > 0) == want.get(name, False),
                  f"auto n={n_auto}: {name} launched {ran}x")
        for cap, res in zip(capacities, results):
            if cap:
                check_fill(res, a_expected, f"auto n={n_auto}")
            else:
                check_count(res, a_expected, f"auto n={n_auto}")
        if n_auto == AUTO_SCENES[0][0]:
            cut = collide(a, ar, TRUNC_CAPACITY)
            with plain_kernels():
                plain_cut = collide(a, ar, TRUNC_CAPACITY)
            check(bool(cut.ok) and int(cut.count) == len(a_expected),
                  f"auto n={n_auto} capacity {TRUNC_CAPACITY}: true total")
            check(torch.equal(cut.pairs, plain_cut.pairs),
                  f"auto n={n_auto} capacity {TRUNC_CAPACITY}: pairs == plain "
                  "path's, bit for bit")
            got = pair_array_to_set(cut.pairs.cpu().numpy(), TRUNC_CAPACITY)
            check(len(got) == TRUNC_CAPACITY and got <= a_expected,
                  f"auto n={n_auto} capacity {TRUNC_CAPACITY}: distinct "
                  "oracle pairs")

    # --- the column kernels against their plain versions at auto's fill
    # plan (262144 spheres); sweep_masks' record: the dense exact plan,
    # where its largest launches are (dense_fill) ---
    a, ar = auto_scenes[AUTO_SCENES[0][0]]
    plan = columns.plan_columns(a, ar, *columns.default_column_config(
        AUTO_SCENES[0][0]))
    phase("column_kernel_plan", n=AUTO_SCENES[0][0], gxy=plan.gxy, mc=plan.mc,
          rows_needed=int(plan.rows_needed), rows_rolled=int(plan.rows_rolled))
    work = column_plan_work(plan, 2, f"auto n={AUTO_SCENES[0][0]}", 2)
    phase("column_masks_262144", ms=work["masks"]["ms"],
          bound_ms=work["masks"]["bound_ms"])

    # --- column step times, kernel path and plain path ---
    for n_s, (c, r) in ((AUTO_SCENES[0][0], auto_scenes[AUTO_SCENES[0][0]]),
                        (N, (coords, radii))):
        col_steps = {}
        for label, capacity in (("count_step", 0), ("fill_step", CAPACITY)):
            col_steps[label + "_ms"] = time_ms(
                lambda: collide(c, r, capacity, method="column"))
            with plain_kernels():
                col_steps[label + "_plain_ms"] = time_ms(
                    lambda: collide(c, r, capacity, method="column"))
        phase("column_steps", n=n_s, **col_steps)

    # --- auto on the two mixed-radii scenes: the hetero engine ---
    hetero_scenes = {}
    hetero_fills = {}
    big_launches = {"big_count": 0, "big_pairs": 0}
    for name, scene in (("hetero_powerlaw", powerlaw_scene),
                        ("hetero_giants", giants_scene)):
        c, r, run, hetero_fills[name] = hetero_path(name, scene, dev)
        hetero_scenes[name] = (c, r)
        for kernel in big_launches:
            big_launches[kernel] += run[kernel]
    launches.update(big_launches)

    # --- the big kernels against their plain versions at the power-law
    # route's parked column plan and the giants route's parked slab plan
    # (records: the power-law plan) ---
    t0 = time.perf_counter()
    big_plans = {}
    for name, (c, r) in hetero_scenes.items():
        _, _, parked, bigs = hetero._split(c, r, None)
        knobs = HETERO_ROUTES[name][0]
        if knobs[0] == "column":
            hplan = columns.plan_columns(c, parked, *knobs[1:4])
            # The S-S count runs the rolled kernel one row short of the
            # fill's rung (hetero.hetero_collide).
            column_plan_work(hplan, knobs[4], name, knobs[4] - 1)
        else:
            hplan = slabs.plan_slabs(c, parked,
                                     *slabs.default_slab_config(N, gx=knobs[1]))
        big_plans[name] = (bigs, hplan.stream)
    fields, errs = {}, {}
    for name, (bigs, stream) in big_plans.items():
        errs[name], tot = big_kernels_agree(bigs, stream, name)
        tests, dense = big_tests(bigs, stream)
        fields[name] = {"stream_rows": stream.shape[0],
                        "big_chunks": bigs[0].shape[0], "tests": tests,
                        "dense_tests": dense, "big_small_pairs": tot,
                        "count_ms": time_ms(
                            lambda: bigpass.big_count_only(bigs, stream),
                            batch=KERNEL_BATCH),
                        "pairs_ms": time_ms(
                            lambda: bigpass.big_pairs(bigs, stream,
                                                      HETERO_CAPACITY),
                            batch=KERNEL_BATCH),
                        "emit_pass": big_emit_pass(bigs, stream,
                                                   HETERO_CAPACITY)}
    bigs, stream = big_plans["hetero_powerlaw"]
    tests, dense = big_tests(bigs, stream)
    # The big table and the stream's box channels (the pairs also read
    # the ids).
    big_in = nbytes(*bigs) + stream_bytes(stream)
    err = errs["hetero_powerlaw"]
    record("big_count", "collision_tpu_torch/csrc/bigpass.cu",
           "collision_tpu/kernels/bigpass.py:281", err,
           lambda: bigpass.big_count_only(bigs, stream),
           lambda: bigpass.big_count_only_plain(bigs, stream), big_in + 8,
           tests, plain_batch=2, dense_tests=dense)
    got = bigpass.big_pairs(bigs, stream, HETERO_CAPACITY)
    want = bigpass.big_pairs_plain(bigs, stream, HETERO_CAPACITY)
    check(int(got[1].ne(0xFFFFFFFF).sum()) == int(got[2]) > 0,
          f"big_pairs: {int(got[2])} pairs, every one written")
    emit = fields["hetero_powerlaw"]["emit_pass"]
    record("big_pairs", "collision_tpu_torch/csrc/bigpass.cu",
           "collision_tpu/kernels/bigpass.py:87",
           max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
               abs(int(got[2]) - int(want[2]))),
           lambda: bigpass.big_pairs(bigs, stream, HETERO_CAPACITY),
           lambda: bigpass.big_pairs_plain(bigs, stream, HETERO_CAPACITY),
           big_in + stream_bytes(stream, 1) + 8 * HETERO_CAPACITY + 8,
           tests, plain_batch=2,
           dense_tests=dense, extra={"emit_pass": emit})
    phase("big_kernel_plan", n=N, plans=fields,
          seconds=time.perf_counter() - t0)

    # --- hetero step times, kernel path and plain path ---
    for name, (c, r) in hetero_scenes.items():
        t0 = time.perf_counter()
        het_steps = {}
        for label, capacity in (("count_step", 0),
                                ("fill_step", HETERO_CAPACITY)):
            het_steps[label + "_ms"] = time_ms(lambda: collide(c, r, capacity))
            with plain_kernels():
                het_steps[label + "_plain_ms"] = time_ms(
                    lambda: collide(c, r, capacity), reps=5)
        phase("hetero_steps", scene=name, n=N,
              fill_capacity=HETERO_CAPACITY, **het_steps,
              seconds=time.perf_counter() - t0)

    # --- the emission kernel above 2^21 pairs ---
    big_capacity(
        [("slab_uniform", lambda: collide(coords, radii, BIG_CAPACITY,
                                          method="slab"), res_fill)]
        + [(name, lambda c=c, r=r: collide(c, r, BIG_CAPACITY),
            hetero_fills[name]) for name, (c, r) in hetero_scenes.items()])
    dense_fill(dev, record, launches)
    grid_path(dev, record, launches, coords, radii, expected,
              dense_oracle(dev))
    cull_edges(dev)
    float64_path(dev, coords_np, radii_np)

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
