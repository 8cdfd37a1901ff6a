"""Pair fill over the sweep engines' packed masks (collision_tpu/fill.py).

The column fill (``mask_fill``, ``column_fill_from_plan``) tests every
chunk against ``rpw`` aligned rows of its 5 windows. The slab fill
(``slab_mask_fill``, ``slab_fill_from_plan``) tests every chunk against
one rolled row of its 2 windows (two rows in the hetero engine's slab
pass), and the rare window remainders past them go to
``slabs.residual_pairs``, appended after the mask pairs. A sparse
two-level emission decodes the mask words into pairs in (mask row, lane,
bit) order. Ids are uint32 values held in int64; unused slots hold
0xFFFFFFFF.

Emission is plain PyTorch, as it is plain XLA in the JAX package. Only
the sparse emission is ported: capacities above ``BIG_FILL_THRESHOLD``
(the JAX package's blocked and in-kernel emitters) make ``collide``
raise ``NotImplementedError``.
"""

import torch

from .columns import CHUNK, LANE, plan_columns
from .kernels import slab_sweep, sweep
from .ops import inclusive_scan, sorted_bucket_starts
from .slabs import NO_PAIR, SLAB_OFFSETS, plan_slabs, residual_pairs

#: Capacity above which the JAX package switches to its blocked and
#: in-kernel emitters, which are not ported yet.
BIG_FILL_THRESHOLD = 1 << 21

def _popcount(w):
    """Set bits of each uint32 value held in an int64 tensor (SWAR: torch
    has no popcount op)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) >> 24) & 0xFF


def _select_bit(word, rank):
    """Index of the ``rank``-th set bit of ``word`` (binary partition by
    popcount, five rounds)."""
    pos = torch.zeros_like(word)
    rem = rank
    for width in (16, 8, 4, 2, 1):
        c = _popcount(word & (((1 << width) - 1) << pos))
        right = c <= rem
        rem = torch.where(right, rem - c, rem)
        pos = torch.where(right, pos + width, pos)
    return pos


def _mask_fill_emit(W, rp, starts, w0_flat, mc, ids_flat, capacity, total,
                    noff, rpw, rolled):
    """(ida, idb, trunc_safe): the first ``capacity`` pairs of packed
    sweep masks, in (mask row, lane, bit) order.

    The masks are the column engine's (``noff=5`` offsets, ``rpw``
    aligned rows: lane l of window row r is sorted sphere
    (w0 // 128 + r) * 128 + l) or the slab engine's (``noff=2``,
    ``rpw=1``, ``rolled=True``: lane l is w0 + l). ``W`` is the mask
    buffer as int64 words [rows, 128], ``rp`` its
    per-row popcounts. Rows with no set bit, then words with no set bit,
    are compacted away, at most ``capacity + 8`` of each (each kept row
    and word holds a pair, so the prefix is exact; ``trunc_safe`` says
    when the cut provably kept every pair below ``capacity``). Each slot
    then finds its word by a searchsorted into the kept words' cumulative
    popcounts, its bit by rank-select, and decodes (row, lane, bit) to
    the two sorted positions.
    """
    dev = W.device
    kg, ng = sweep.mask_groups(mc, rpw)
    kgt = kg * noff * rpw
    Rw = W.shape[0]
    imax = 2 ** 31 - 1
    cap_k = capacity + 8

    # --- level 1: compact hit rows ---
    RK = max(min(Rw, cap_k), 1)
    ic_r = inclusive_scan((rp > 0).to(torch.int32))
    nkr = ic_r[-1]
    ordr = torch.arange(RK, device=dev)
    rsel = torch.clamp_max(sorted_bucket_starts(ic_r, ordr + 1), Rw - 1)
    rows = torch.where((ordr < nkr)[:, None], W[rsel], 0)       # [RK, 128]
    csum_rp = inclusive_scan(rp)
    safe_r = (nkr <= RK) | (csum_rp[rsel[RK - 1]] >= capacity)

    # --- level 2: compact nonzero words within kept rows ---
    wflat = rows.reshape(-1)
    wpcf = _popcount(wflat)
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
    bit = _select_bit(wval[sel], rank)
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
    return (torch.where(live, ida, NO_PAIR), torch.where(live, idb, NO_PAIR),
            safe_r & safe_w)


def _mask_words(B):
    """(W, rp, total): a mask buffer as int64 words [rows, 128], each
    row's set bits, and the exact int64 number of set bits."""
    W = B.reshape(-1, LANE).long() & 0xFFFFFFFF
    rp = _popcount(W).sum(dim=1)
    return W, rp, rp.sum()


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


def column_fill_from_plan(plan, capacity, rpw):
    """(ida[capacity], idb[capacity], total, ok) from a column plan: the
    masks kernel at ``rpw`` aligned rows and the sparse emission. The
    uniform column fill and the hetero engine's column S-S pass share it.

    ``total`` is the true int64 pair count even past ``capacity`` (at
    most ``BIG_FILL_THRESHOLD``; ``collide`` checks it). ``ok`` is False
    when the plan's capacities or ``rpw`` were too small
    (``plan.rows_needed > rpw``), when the total reached the JAX
    package's int32 guard, or when the emission's row cut could have
    dropped a pair.
    """
    W, rp, total = _mask_words(sweep.sweep_masks(plan, rpw))
    ok = plan.ok & (plan.rows_needed <= rpw) & (total < sweep.INT32_GUARD)
    ida, idb, trunc_safe = _mask_fill_emit(
        W, rp, plan.starts.long(), plan.w0.reshape(-1).long(), plan.mc,
        _sorted_ids(plan), capacity, total, noff=sweep.NOFF, rpw=rpw,
        rolled=False)
    return ida, idb, total, ok & trunc_safe


def slab_fill_from_plan(plan, capacity, dual_base=1, split_ok=False):
    """(ida[capacity], idb[capacity], total, ok) from a slab plan: the
    mask pairs of the masks kernel at ``dual_base`` rolled rows (windows
    clamped to dual_base*128 lanes), then the residual pairs of the lanes
    past them, truncated at ``capacity`` (at most ``BIG_FILL_THRESHOLD``;
    ``collide`` checks it). The uniform slab fill runs one row, the
    hetero engine's slab S-S pass two.

    ``total`` is the true int64 pair count even past ``capacity``. ``ok``
    is False when the plan's capacities, the residual job or pair
    capacity or the JAX package's int32 guard were exceeded, or when the
    emission's row cut could have dropped a pair. ``split_ok`` returns
    (ida, idb, total, gx_ok, other_ok) instead: gx_ok is what a finer
    slab grid can fix (plan and residual capacities), other_ok the rest.
    """
    sweep_plan = plan._replace(
        wcap=torch.clamp_max(plan.wcap, dual_base * LANE))
    W, rp, mask_total = _mask_words(
        slab_sweep.slab_sweep_masks(sweep_plan, dual_base))
    rida, ridb, rcount, r_ok = residual_pairs(plan, base=dual_base)
    total = mask_total + rcount
    gx_ok = plan.ok & r_ok
    no_wrap = mask_total < sweep.INT32_GUARD
    ida, idb, trunc_safe = _mask_fill_emit(
        W, rp, plan.starts.long(), plan.w0.reshape(-1).long(), plan.mc,
        _sorted_ids(plan), capacity, mask_total, noff=len(SLAB_OFFSETS),
        rpw=dual_base, rolled=True)

    # Append the residual pairs after the mask pairs.
    q = torch.arange(capacity, device=W.device)
    tm = torch.clamp_max(mask_total, capacity)
    in_m = q < tm
    qr = torch.clamp(q - tm, 0, rida.shape[0] - 1)
    live = q < torch.clamp_max(total, capacity)
    ida = torch.where(live, torch.where(in_m, ida, rida[qr]), NO_PAIR)
    idb = torch.where(live, torch.where(in_m, idb, ridb[qr]), NO_PAIR)
    if split_ok:
        return ida, idb, total, gx_ok, no_wrap & trunc_safe
    return ida, idb, total, gx_ok & no_wrap & trunc_safe


def slab_mask_fill(coords, radii, capacity, gx, col_capacity, slab_rows):
    """Plan and fill in one call: (ida, idb, total, ok) as in
    :func:`slab_fill_from_plan`."""
    plan = plan_slabs(coords, radii, gx, col_capacity, slab_rows)
    return slab_fill_from_plan(plan, capacity)
