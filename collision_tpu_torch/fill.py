"""Pair fill over the slab engine's packed masks.

Port of the slab part of collision_tpu/fill.py: the masks kernel tests
every chunk against one row of its windows, the rare window remainders
past 128 lanes go to ``slabs.residual_pairs``, and a sparse two-level
emission decodes the mask words into pairs in (mask row, lane, bit)
order, the residual pairs appended after them. Ids are uint32 values held
in int64; unused slots hold 0xFFFFFFFF.

Emission is plain PyTorch, as it is plain XLA in the JAX package. Only
the sparse emission is ported: capacities above ``BIG_FILL_THRESHOLD``
(the JAX package's blocked and in-kernel emitters) make ``collide``
raise ``NotImplementedError``.
"""

import torch

from .columns import CHUNK, LANE
from .kernels import slab_sweep
from .kernels.sweep import mask_groups
from .ops import inclusive_scan, sorted_bucket_starts
from .slabs import NO_PAIR, SLAB_OFFSETS, plan_slabs, residual_pairs

#: Capacity above which the JAX package switches to its blocked and
#: in-kernel emitters, which are not ported yet.
BIG_FILL_THRESHOLD = 1 << 21

_NOFF = len(SLAB_OFFSETS)


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


def _mask_fill_emit(W, rp, starts, w0_flat, mc, ids_flat, capacity, total):
    """(ida, idb, trunc_safe): the first ``capacity`` pairs of the packed
    slab masks, in (mask row, lane, bit) order.

    ``W`` is the mask buffer as int64 words [rows, 128], ``rp`` its
    per-row popcounts. Rows with no set bit, then words with no set bit,
    are compacted away, at most ``capacity + 8`` of each (each kept row
    and word holds a pair, so the prefix is exact; ``trunc_safe`` says
    when the cut provably kept every pair below ``capacity``). Each slot
    then finds its word by a searchsorted into the kept words' cumulative
    popcounts, its bit by rank-select, and decodes (row, lane, bit) to
    the two sorted positions.
    """
    dev = W.device
    kg, ng = mask_groups(mc)
    kgt = kg * _NOFF
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
    k = torch.clamp_max((nb % ng) * kg + sl // _NOFF, mc - 1)
    off = sl % _NOFF
    nsort = ids_flat.shape[0]
    i = starts[torch.clamp_max(colg, starts.shape[0] - 1)] + k * CHUNK \
        + h * 32 + bit
    j = w0_flat[(colg * mc + k) * _NOFF + off] + lane
    ida = ids_flat[torch.clamp(i, 0, nsort - 1)]
    idb = ids_flat[torch.clamp(j, 0, nsort - 1)]
    live = q < torch.clamp_max(total, capacity)
    return (torch.where(live, ida, NO_PAIR), torch.where(live, idb, NO_PAIR),
            safe_r & safe_w)


def slab_fill_from_plan(plan, capacity):
    """(ida[capacity], idb[capacity], total, ok) from a slab plan: the
    mask pairs, then the residual pairs, truncated at ``capacity``
    (at most ``BIG_FILL_THRESHOLD``; ``collide`` checks it).

    ``total`` is the true int64 pair count even past ``capacity``. ``ok``
    is False when the plan's capacities, the residual job or pair
    capacity or the JAX package's int32 guard were exceeded, or when the
    emission's row cut could have dropped a pair.
    """
    B = slab_sweep.slab_sweep_masks(plan)
    W = B.reshape(-1, LANE).long() & 0xFFFFFFFF
    rp = _popcount(W).sum(dim=1)
    mask_total = rp.sum()
    rida, ridb, rcount, r_ok = residual_pairs(plan)
    total = mask_total + rcount
    ok = plan.ok & r_ok & (mask_total < 2 ** 31 - 2 ** 26)

    ids_flat = plan.stream[:, 6, :].reshape(-1).view(torch.int32).long() \
        & 0xFFFFFFFF
    ida, idb, trunc_safe = _mask_fill_emit(
        W, rp, plan.starts.long(), plan.w0.reshape(-1).long(), plan.mc,
        ids_flat, capacity, mask_total)

    # Append the residual pairs after the mask pairs.
    q = torch.arange(capacity, device=B.device)
    tm = torch.clamp_max(mask_total, capacity)
    in_m = q < tm
    qr = torch.clamp(q - tm, 0, rida.shape[0] - 1)
    live = q < torch.clamp_max(total, capacity)
    ida = torch.where(live, torch.where(in_m, ida, rida[qr]), NO_PAIR)
    idb = torch.where(live, torch.where(in_m, idb, ridb[qr]), NO_PAIR)
    return ida, idb, total, ok & trunc_safe


def slab_mask_fill(coords, radii, capacity, gx, col_capacity, slab_rows):
    """Plan and fill in one call: (ida, idb, total, ok) as in
    :func:`slab_fill_from_plan`."""
    plan = plan_slabs(coords, radii, gx, col_capacity, slab_rows)
    return slab_fill_from_plan(plan, capacity)
