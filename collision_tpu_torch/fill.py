"""Pair fills: the run-expansion fill, and the fill over the sweep
engines' packed masks (collision_tpu/fill.py).

The run-expansion fill (``run_fill``, ``candidate_count``) is the JAX
package's portable path: plain tensor code at the input's precision,
float32 or float64, and the only path of float64 steps. For each sorted
sphere and each of the 5 half-stencil columns, the conservative z-window
of possible partners is one run of the column-sorted order; the runs'
candidates are tested with the strict box test, in sorted-sphere-major,
offset-minor, ascending-j order. The JAX package's stride pyramid
(``_S``, ``_auto_strides``, ``_run_of_consecutive``) and its chunked
``lax.scan`` exist for the TPU's gathers and are gone: one
``searchsorted`` finds each candidate's run, and the candidate pass is
chunked only to bound memory.

The column fill (``column_fill_pairs``) tests every chunk against
``rpw`` aligned rows of its 5 windows. The slab fill
(``slab_fill_pairs``) tests every chunk against one rolled row of its 2
windows (two rows in the hetero engine's slab pass), and the rare window
remainders past them go to ``slabs.residual_pairs``, appended after the
mask pairs. The emission decodes the mask words into pairs in (mask row,
lane, bit) order. Ids are uint32 values held in int64; unused slots hold
0xFFFFFFFF. Both fills return the int64 ``[capacity, 2]`` pair buffer
that a collision result holds; the JAX package's forms (``mask_fill``,
``column_fill_from_plan``, ``slab_mask_fill``, ``slab_fill_from_plan``)
return its two columns, as views.

Two emitters, as in the JAX package (``_pick_emit``): up to
``BIG_FILL_THRESHOLD`` slots the sparse two-level compaction of
``_mask_fill_emit`` (plain PyTorch); above it ``kernels/pair_emit``
(a CUDA kernel on the card, the blocked plain emission on the CPU).
"""

import torch

from . import tracing
from .columns import (CHUNK, COLUMN_OFFSETS, LANE, _column_sort, _quantize,
                      _zbits, plan_columns)
from .kernels import pair_emit, slab_sweep, sweep
from .kernels.pair_emit import popcount, row_words, select_bit
from .ops import inclusive_scan, sorted_bucket_starts
from .slabs import NO_PAIR, SLAB_OFFSETS, plan_slabs, residual_pairs
from .utils import round_up

#: The JAX package rounds the candidate pass's chunk to a multiple of its
#: run lookup's refine width, 8; ``run_fill`` rounds ``cand_capacity`` by
#: the same chunk, so that both packages bound the candidates alike.
_CHUNK_ROUND = 8
#: Candidates tested per pass (the JAX package's default chunk): bounds
#: the pass's memory.
_CHUNK = 1 << 20


def _candidate_runs(key_s, c_s, r_s, lo_s, zscale, r_max, gxy):
    """(run_w0, run_len), int64 [5n]: each sorted sphere's conservative
    z-window run in each of the 5 half-stencil columns, sphere-major and
    offset-minor (|z_i - z_j| < r_i + r_max is necessary for overlap).
    The self column's run starts at i + 1, the j > i dedup."""
    n = key_s.shape[0]
    dev = key_s.device
    zbits = _zbits(gxy)
    zmax = (1 << zbits) - 1
    col_s = key_s >> zbits
    cx, cy = col_s // gxy, col_s % gxy
    z_s = c_s[:, 2]
    half = r_s + r_max
    qlo = _quantize(z_s - half, lo_s[2], zscale, zmax)
    qhi = _quantize(z_s + half, lo_s[2], zscale, zmax)
    keys, valid = [], []
    for dx, dy in COLUMN_OFFSETS:
        xb, yb = cx + dx, cy + dy
        valid.append((yb >= 0) & (yb < gxy) & (xb < gxy))
        cb = (xb * gxy + torch.clamp(yb, 0, gxy - 1)) << zbits
        keys += [cb + qlo, cb + qhi + 1]
    pos = sorted_bucket_starts(key_s, torch.stack(keys).reshape(-1)) \
        .reshape(5, 2, n)
    w0s, lens = [], []
    for off, (dx, dy) in enumerate(COLUMN_OFFSETS):
        w0 = pos[off, 0]
        if (dx, dy) == (0, 0):
            w0 = torch.maximum(w0, torch.arange(1, n + 1, device=dev))
        w0s.append(torch.where(valid[off], w0, 0))
        lens.append(torch.where(valid[off], (pos[off, 1] - w0).clamp_min(0),
                                0))
    return torch.stack(w0s, 1).reshape(-1), torch.stack(lens, 1).reshape(-1)


def candidate_count(coords, radii, gxy):
    """The exact int64 number of conservative candidates of
    :func:`run_fill` at ``gxy`` columns per axis: the ``cand_capacity``
    a scene needs. The JAX package returns a float32 sum, accurate to
    ~2^-20 relative."""
    key_s, _, c_s, r_s, lo_s, zscale, r_max, _ = _column_sort(coords,
                                                              radii, gxy)
    return _candidate_runs(key_s, c_s, r_s, lo_s, zscale, r_max,
                           gxy)[1].sum()


@tracing.spanned("ct.runfill")
def run_fill(coords, radii, capacity, gxy, cand_capacity):
    """Enumerate colliding pairs by run expansion, at input precision.

    Args:
      coords: [n, 3] float32 or float64 centers; radii: [n], same type
        and device.
      capacity: pair-buffer capacity (0 = count-only).
      gxy: columns per xy axis (``columns.default_column_config``).
      cand_capacity: bound on conservative candidates, rounded up to a
        multiple of the candidate pass's chunk as in the JAX package;
        where the scene needs more, ``ok`` is False and the result counts
        only the first ``cand_capacity`` candidates (a correct prefix).

    Returns:
      (pairs int64 [capacity, 2] of original ids or None, total int64,
      ok): the first ``capacity`` pairs in candidate order
      (sorted-sphere-major, offset-minor, ascending j), 0xFFFFFFFF past
      them; ``ok`` is False past ``cand_capacity`` candidates or at
      ``sweep.INT32_GUARD`` of them.
    """
    cand_capacity = int(cand_capacity)
    chunk = round_up(min(_CHUNK, max(_CHUNK_ROUND, round_up(
        cand_capacity, _CHUNK_ROUND))), _CHUNK_ROUND)
    cand_capacity = round_up(cand_capacity, chunk)
    dev = coords.device
    key_s, order, c_s, r_s, lo_s, zscale, r_max, _ = _column_sort(
        coords, radii, gxy)
    run_w0, run_len = _candidate_runs(key_s, c_s, r_s, lo_s, zscale, r_max,
                                      gxy)
    total_cand = run_len.sum()
    ok = (total_cand <= cand_capacity) & (total_cand < sweep.INT32_GUARD)
    # The run of candidate k is the first with ic > k: zero-length runs
    # never are, so the JAX package's compaction of them is implicit.
    ic = torch.cumsum(run_len, 0)
    ex = ic - run_len
    lo = c_s - r_s[:, None]
    hi = c_s + r_s[:, None]

    total = torch.zeros((), dtype=torch.int64, device=dev)
    found_a, found_b, found = [], [], 0
    tracing.host_sync("fill.run_fill")
    ncand = min(int(total_cand), cand_capacity)
    for k0 in range(0, ncand, chunk):
        k = torch.arange(k0, min(k0 + chunk, ncand), device=dev)
        r = torch.searchsorted(ic, k, right=True)
        i = r // 5
        j = run_w0[r] + (k - ex[r])
        m = ((hi[i] > lo[j]) & (lo[i] < hi[j])).all(1)
        total += m.sum()
        if found < capacity:
            tracing.host_sync("fill.run_fill")
            sel = torch.nonzero(m).flatten()[:capacity - found]
            found_a.append(order[i[sel]])
            found_b.append(order[j[sel]])
            found += sel.numel()
    if capacity == 0:
        return None, total, ok
    pairs = torch.full((capacity, 2), NO_PAIR, dtype=torch.int64, device=dev)
    if found:
        pairs[:found] = torch.stack([torch.cat(found_a), torch.cat(found_b)],
                                    1)
    return pairs, total, ok


#: Capacity above which the emission leaves the sparse path, whose
#: compaction tables and searchsorted windows are capacity-sized, for
#: the pair-emission kernel.
BIG_FILL_THRESHOLD = 1 << 21


def _mask_fill_emit(B, rp, starts, w0_flat, mc, ids_flat, capacity, total,
                    noff, rpw, rolled):
    """(pairs int64[capacity, 2], trunc_safe): the first ``capacity``
    pairs of packed sweep masks, in (mask row, lane, bit) order.

    The masks are the column engine's (``noff=5`` offsets, ``rpw``
    aligned rows: lane l of window row r is sorted sphere
    (w0 // 128 + r) * 128 + l) or the slab engine's (``noff=2``,
    ``rpw=1``, ``rolled=True``: lane l is w0 + l). ``B`` is the mask
    buffer, ``rp`` its int64 per-row popcounts. Rows with no set bit,
    then words with no set bit, are compacted away, at most
    ``capacity + 8`` of each (each kept row
    and word holds a pair, so the prefix is exact; ``trunc_safe`` says
    when the cut provably kept every pair below ``capacity``). Each slot
    then finds its word by a searchsorted into the kept words' cumulative
    popcounts, its bit by rank-select, and decodes (row, lane, bit) to
    the two sorted positions.
    """
    dev = B.device
    kg, ng = sweep.mask_groups(mc, rpw)
    kgt = kg * noff * rpw
    Rw = rp.shape[0]
    imax = 2 ** 31 - 1
    cap_k = capacity + 8

    # --- level 1: compact hit rows ---
    RK = max(min(Rw, cap_k), 1)
    ic_r = inclusive_scan((rp > 0).to(torch.int32))
    nkr = ic_r[-1]
    ordr = torch.arange(RK, device=dev)
    rsel = torch.clamp_max(sorted_bucket_starts(ic_r, ordr + 1), Rw - 1)
    rows = torch.where((ordr < nkr)[:, None], row_words(B, rsel), 0)
    csum_rp = inclusive_scan(rp)
    # Indexing by a 0-dim device tensor reads it on the host (here and
    # at ``safe_w``).
    tracing.host_sync("fill._mask_fill_emit", 2)
    safe_r = (nkr <= RK) | (csum_rp[rsel[RK - 1]] >= capacity)

    # --- level 2: compact nonzero words within kept rows ---
    wflat = rows.reshape(-1)
    wpcf = popcount(wflat)
    ic_pf = inclusive_scan(wpcf)    # pair cum (== global: dropped rows are empty)
    WK = max(min(RK * LANE, cap_k), 1)
    ic_w = inclusive_scan((wpcf > 0).to(torch.int32))
    nkw = ic_w[-1]
    ordw = torch.arange(WK, device=dev)
    wsel = torch.clamp_max(sorted_bucket_starts(ic_w, ordw + 1),
                           RK * LANE - 1)
    live_w = ordw < nkw
    wval = torch.where(live_w, wflat[wsel], 0)
    wpc_s = torch.where(live_w, wpcf[wsel], 0)
    wcum_s = torch.where(live_w, ic_pf[wsel], imax)
    grow_w = rsel[wsel // LANE]                  # global mask row per word
    lane_w = wsel % LANE
    safe_w = (nkw <= WK) | (ic_pf[wsel[WK - 1]] >= capacity)

    # --- per-slot resolution ---
    q = torch.arange(capacity, device=dev)
    sel = torch.clamp_max(sorted_bucket_starts(wcum_s, q + 1), WK - 1)
    rank = torch.clamp_min(q - (wcum_s[sel] - wpc_s[sel]), 0)
    bit = select_bit(wval[sel], rank)
    R = grow_w[sel]
    lane = lane_w[sel]

    # --- decode (mask row, lane, bit) -> sorted stream positions ---
    h = R % 2
    sl = (R // 2) % kgt
    nb = R // (2 * kgt)
    colg = nb // ng
    k = torch.clamp_max((nb % ng) * kg + sl // (noff * rpw), mc - 1)
    off = (sl // rpw) % noff
    r = sl % rpw
    nsort = ids_flat.shape[0]
    i = starts[torch.clamp_max(colg, starts.shape[0] - 1)] + k * CHUNK \
        + h * 32 + bit
    w0u = w0_flat[(colg * mc + k) * noff + off]
    if rolled:
        j = w0u + r * LANE + lane
    else:
        j = (w0u // LANE + r) * LANE + lane
    ida = ids_flat[torch.clamp(i, 0, nsort - 1)]
    idb = ids_flat[torch.clamp(j, 0, nsort - 1)]
    live = q < torch.clamp_max(total, capacity)
    return (torch.where(live[:, None], torch.stack([ida, idb], 1), NO_PAIR),
            safe_r & safe_w)


def _emit_tables(B, starts, w0_flat, mc, noff, rpw, rolled):
    """(wstart_tab, cb_tab), int64 [NB, KGT]: each mask row group's
    sorted window start and chunk start, by reshapes and broadcasts of
    the plan's window table, for the rolled (slab) and the aligned
    (column) layout. A group past the last chunk (KG*NG > mc) gets the
    last chunk's windows, as in the JAX package; its rows are empty."""
    kg, ng = sweep.mask_groups(mc, rpw)
    kgt = kg * noff * rpw
    NB = B.shape[0]
    ncols = NB // ng
    dev = B.device
    w3 = w0_flat.reshape(ncols, mc, noff)
    pad = kg * ng - mc
    if pad:
        w3 = torch.cat([w3, w3[:, -1:, :].expand(ncols, pad, noff)], dim=1)
    w4 = w3.reshape(NB, kg, noff, 1)
    r_i = torch.arange(rpw, device=dev)
    if rolled:
        wstart = w4 + r_i * LANE
    else:
        wstart = (w4 // LANE + r_i) * LANE
    k_tab = torch.clamp_max(
        torch.arange(ng, device=dev)[:, None] * kg
        + torch.arange(kg, device=dev)[None, :], mc - 1)      # [ng, kg]
    cb3 = starts[:ncols, None, None] + k_tab[None] * CHUNK     # [ncols, ng, kg]
    cb_tab = cb3.reshape(NB, kg, 1).expand(NB, kg, noff * rpw)
    return wstart.reshape(NB, kgt), cb_tab.reshape(NB, kgt)


def _mask_fill_emit_kernel(B, rp, starts, w0_flat, mc, ids_flat, capacity,
                           total, noff, rpw, rolled):
    """The pair-emission kernel (``pair_emit.emit_pair_buffer``) over the
    rows' tables: (pairs, trunc_safe), the kernel's buffer as it is. Exact
    at any capacity, so ``trunc_safe`` is True. ``total`` is unused:
    slots past the mask pairs hold 0xFFFFFFFF."""
    wstart_tab, cb_tab = _emit_tables(B, starts, w0_flat, mc, noff, rpw,
                                      rolled)
    pairs = pair_emit.emit_pair_buffer(B, wstart_tab, cb_tab, ids_flat,
                                       capacity, rp)
    return pairs, torch.ones((), dtype=torch.bool, device=B.device)


def _pick_emit(capacity):
    """The emission for a capacity: the sparse path up to
    ``BIG_FILL_THRESHOLD``, the kernel above it. The JAX package falls
    back to its blocked path when the sorted ids do not fit the TPU's
    VMEM (``KERNEL_EMIT_MAX_IDS``); the card has no such limit, so the
    kernel takes every capacity above the threshold."""
    if capacity > BIG_FILL_THRESHOLD:
        return _mask_fill_emit_kernel
    return _mask_fill_emit


def _sorted_ids(plan):
    """The original ids in sorted order (uint32 values in int64), from
    the stream's id channel."""
    return plan.stream[:, 6, :].reshape(-1).view(torch.int32).long() \
        & 0xFFFFFFFF


def mask_fill(coords, radii, capacity, gxy, col_capacity, slab_rows, rpw=2):
    """Column-engine pair fill: (ida[capacity], idb[capacity], total,
    ok), as :func:`column_fill_from_plan` over the column plan."""
    plan = plan_columns(coords, radii, gxy, col_capacity, slab_rows)
    return column_fill_from_plan(plan, capacity, rpw)


def column_fill_pairs(plan, capacity, rpw):
    """(pairs int64[capacity, 2], total, ok) from a column plan: the masks
    kernel at ``rpw`` aligned rows and the emission :func:`_pick_emit`
    picks. The uniform column fill and the hetero engine's column S-S
    pass share it.

    ``total`` is the true int64 pair count even past ``capacity``. ``ok``
    is False when the plan's capacities or ``rpw`` were too small
    (``plan.rows_needed > rpw``), when the total reached the JAX
    package's int32 guard, or when the sparse emission's row cut could
    have dropped a pair.
    """
    with tracing.span("ct.column.sweep"):
        B = sweep.sweep_masks(plan, rpw)
        rp = pair_emit.row_popcounts(B)
    total = rp.sum()
    ok = plan.ok & (plan.rows_needed <= rpw) & (total < sweep.INT32_GUARD)
    with tracing.span("ct.column.emit"):
        pairs, trunc_safe = _pick_emit(capacity)(
            B, rp, plan.starts.long(), plan.w0.reshape(-1).long(), plan.mc,
            _sorted_ids(plan), capacity, total, noff=sweep.NOFF, rpw=rpw,
            rolled=False)
    return pairs, total, ok & trunc_safe


def column_fill_from_plan(plan, capacity, rpw):
    """(ida[capacity], idb[capacity], total, ok): the columns of
    :func:`column_fill_pairs`, as views."""
    pairs, total, ok = column_fill_pairs(plan, capacity, rpw)
    return pairs[:, 0], pairs[:, 1], total, ok


def slab_fill_pairs(plan, capacity, dual_base=1, split_ok=False):
    """(pairs int64[capacity, 2], total, ok) from a slab plan: the mask
    pairs of the masks kernel at ``dual_base`` rolled rows (windows
    clamped to dual_base*128 lanes), then the residual pairs of the lanes
    past them, truncated at ``capacity``. The uniform slab fill runs one
    row, the hetero engine's slab S-S pass two.

    ``total`` is the true int64 pair count even past ``capacity``. ``ok``
    is False when the plan's capacities, the residual job or pair
    capacity or the JAX package's int32 guard were exceeded, or when the
    sparse emission's row cut could have dropped a pair. ``split_ok``
    returns (pairs, total, gx_ok, other_ok) instead: gx_ok is what a
    finer slab grid can fix (plan and residual capacities), other_ok the
    rest.
    """
    sweep_plan = plan._replace(
        wcap=torch.clamp_max(plan.wcap, dual_base * LANE))
    with tracing.span("ct.slab.sweep"):
        B = slab_sweep.slab_sweep_masks(sweep_plan, dual_base)
        rp = pair_emit.row_popcounts(B)
    mask_total = rp.sum()
    rida, ridb, rcount, r_ok = residual_pairs(plan, base=dual_base)
    total = mask_total + rcount
    gx_ok = plan.ok & r_ok
    no_wrap = mask_total < sweep.INT32_GUARD
    with tracing.span("ct.slab.emit"):
        pairs, trunc_safe = _pick_emit(capacity)(
            B, rp, plan.starts.long(), plan.w0.reshape(-1).long(), plan.mc,
            _sorted_ids(plan), capacity, mask_total, noff=len(SLAB_OFFSETS),
            rpw=dual_base, rolled=True)

        # Append the residual pairs after the mask pairs.
        q = torch.arange(capacity, device=B.device)
        tm = torch.clamp_max(mask_total, capacity)
        in_m = q < tm
        qr = torch.clamp(q - tm, 0, rida.shape[0] - 1)
        live = q < torch.clamp_max(total, capacity)
        rpairs = torch.stack([rida, ridb], 1)[qr]
        pairs = torch.where(live[:, None],
                            torch.where(in_m[:, None], pairs, rpairs), NO_PAIR)
    if split_ok:
        return pairs, total, gx_ok, no_wrap & trunc_safe
    return pairs, total, gx_ok & no_wrap & trunc_safe


def slab_fill_from_plan(plan, capacity, dual_base=1, split_ok=False):
    """(ida[capacity], idb[capacity], total, ok), or with ``split_ok``
    (ida, idb, total, gx_ok, other_ok): the columns of
    :func:`slab_fill_pairs`, as views."""
    pairs, *rest = slab_fill_pairs(plan, capacity, dual_base, split_ok)
    return (pairs[:, 0], pairs[:, 1], *rest)


def slab_mask_fill(coords, radii, capacity, gx, col_capacity, slab_rows):
    """Plan and fill in one call: (ida, idb, total, ok) as in
    :func:`slab_fill_from_plan`."""
    plan = plan_slabs(coords, radii, gx, col_capacity, slab_rows)
    return slab_fill_from_plan(plan, capacity)
