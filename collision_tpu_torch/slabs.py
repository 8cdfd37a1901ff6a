"""Slab-sweep broad phase: the plan and the residual jobs.

Port of collision_tpu/slabs.py. Spheres sort by ``x_slab << zbits |
quantize(z)``; every 64-sphere chunk of slab x gets one z-window of
candidate partners in slab x (clipped at the chunk start, for the j > i
dedup) and one in slab x+1. Windows are conservative supersets, the
kernel test is exact, and capacity overflows are detected (``ok=False``),
never silently wrong.

Differences from the JAX plan, none of which changes a shared field:
sort keys and positions are int64 (torch's uint32 has no ``<<`` and no
``searchsorted``), and ``slab_r0`` (the TPU kernel's DMA ring) is not
built.
"""

from typing import NamedTuple

import numpy as np
import torch

from .columns import (CHUNK, LANE, _quantize, _scalar, build_stream,
                      chunk_z_ranges)
from .kernels import compact
from .ops import inclusive_scan, scene_bounds, sorted_bucket_starts
from .utils import round_up

#: x half-stencil: the self slab (with j > i) and slab x+1.
SLAB_OFFSETS = (0, 1)

#: Stream rows per block of the diagonal count (kernels/slab_sweep.py):
#: the stream's rows are rounded so that every block but the last has a
#: full successor block, which the count reads and never passes.
DIAG_B = 32

#: Residual-job capacity of the dual-dispatch count; overflow gives
#: ok=False.
RESIDUAL_JOBS = 256

#: Residual-pair capacity of the dual-dispatch fill; overflow gives
#: ok=False.
RESIDUAL_PAIRS = 4096

NO_PAIR = 0xFFFFFFFF


class SlabPlan(NamedTuple):
    """Everything the slab sweep kernels need, plus host-retry stats."""

    stream: torch.Tensor      # [Rp, 8, 128] f32: xlo ylo zlo xhi yhi zhi id slab
    starts: torch.Tensor      # int32[gx + 2] slab start indices (+1 pad slab)
    w0: torch.Tensor          # int32[gx, mc*2] window starts (global)
    wcap: torch.Tensor        # int32[gx, mc*2] window lengths
    ok: torch.Tensor          # bool: capacities held (result exact iff True)
    max_col: torch.Tensor     # int32 stats for host retry
    max_slab_rows: torch.Tensor
    rows_rolled: torch.Tensor  # int32: max ceil(window/128) of any window
    diag_thr: torch.Tensor    # f32[1] z-proximity threshold of the diagonal
                              # count's missed-pair detector
    n: int
    gx: int
    mc: int
    slab_rows: int


def default_slab_config(n, r_max=None, ext=None, target_slack=24, gx=None):
    """(gx, col_capacity, slab_rows) from n and optional scene stats.

    ``gx`` targets z-windows of ~CHUNK + ``target_slack`` spheres: the
    window slack is ~(2*r_mean + 2*r_max) * n / (gx * ext_z), which with
    scene stats unknown (r_max ~ 1/sqrt(n), the uniform family) gives
    gx ~ 3*sqrt(n)/target_slack. Given ``r_max`` and the x extent
    ``ext``, gx is sized from them, and capped at ext/(2*r_max): the
    plan clamps slab width at 2*r_max, so slabs past that ceiling are
    empty. Pass ``gx`` to pin the slab count and derive only the
    capacities.
    """
    if gx is None:
        if r_max is not None and ext is not None and ext > 0:
            gx = 3.0 * float(r_max) * n / (float(ext) * target_slack)
            if r_max > 0:
                gx = min(gx, float(ext) / (2.0 * float(r_max)))
        else:
            gx = 3.0 * (n ** 0.5) / target_slack
    gx = int(np.clip(round(gx), 1, 4096))
    occ = n / gx
    col_cap = int(round_up(int(occ + 6 * occ ** 0.5 + 16), CHUNK))
    col_cap = min(col_cap, int(round_up(n, CHUNK)))
    slab_rows = min(col_cap, n) // LANE + 4
    return gx, col_cap, slab_rows


def _xbits_z(gx):
    # +1 pad slab; +1 so the last slab's upper window threshold
    # (col+1) << zbits never leaves 32 bits.
    return 32 - max(int(np.ceil(np.log2(gx + 2))), 1)


def slab_sort_keys(coords, gx, lo_s, ext, r_max):
    """(int64 ``x_slab << zbits | quantize(z)`` keys, zscale, zext) from
    the scene statistics; ``zext`` is the z extent, or 1 where that is 0."""
    zbits = _xbits_z(gx)
    zmax = (1 << zbits) - 1
    one = _scalar(1.0, coords)
    # Slab width >= 2*r_max: colliding pairs land in the same or an
    # adjacent slab.
    sx = torch.maximum(2 * r_max, ext[0] / _scalar(gx, coords))
    sx = torch.where(sx > 0, sx, one)
    col = torch.clamp(((coords[:, 0] - lo_s[0]) / sx).to(torch.int32),
                      0, gx - 1).to(torch.int64)
    zext = torch.where(ext[2] > 0, ext[2], one)
    zscale = _scalar(zmax, coords) / zext
    zq = _quantize(coords[:, 2], lo_s[2], zscale, zmax)
    return (col << zbits) | zq, zscale, zext


def plan_slabs(coords, radii, gx, col_capacity, slab_rows):
    """Sort by (x-slab, z) and precompute the slab sweep kernels' inputs.

    ``coords`` [n, 3] and ``radii`` [n] are float32 on one device; the
    plan lives there too.
    """
    lo_s, hi_s = scene_bounds(coords)
    r_max = torch.amax(radii)
    ext = hi_s - lo_s
    key, zscale, zext = slab_sort_keys(coords, gx, lo_s, ext, r_max)
    # A stable sort of the keys plus one gather equals the JAX package's
    # stable multi-operand lax.sort.
    key_s, order = torch.sort(key, stable=True)
    c_s = coords.index_select(0, order)
    r_s = radii.index_select(0, order)
    return _plan_from_sorted(
        key_s, order, c_s[:, 0], c_s[:, 1], c_s[:, 2], r_s, gx,
        _xbits_z(gx), lo_s[2], zext, zscale, r_max, col_capacity,
        slab_rows)


def _plan_from_sorted(key_s, ids_s, x_s, y_s, z_s, r_s, gx, zbits, lo_z,
                      zext, zscale, r_max, col_capacity, slab_rows):
    """Stream + window tables from key-sorted sphere data."""
    dev = key_s.device
    n = key_s.shape[0]
    zmax = (1 << zbits) - 1
    mc = -(-col_capacity // CHUNK)
    col_s = key_s >> zbits

    # Slab starts over gx + 2 buckets: the pad slab gx stays empty, which
    # makes the last slab's dx=1 window vacuous.
    starts = sorted_bucket_starts(
        col_s, torch.arange(gx + 2, device=dev)).to(torch.int32)

    # --- stream tensor [Rp, 8, 128] ---
    R = -(-n // LANE)
    Rp = max(-(-(R + slab_rows + 2) // DIAG_B), R // DIAG_B + 2) * DIAG_B
    zlo, zhi = z_s - r_s, z_s + r_s
    stream = build_stream(
        [x_s - r_s, y_s - r_s, zlo, x_s + r_s, y_s + r_s, zhi], ids_s,
        col_s.to(torch.float32).view(torch.int32), Rp)

    # --- exact per-chunk z ranges ---
    lo_chunk, hi_chunk = chunk_z_ranges(starts, gx, mc, zlo, zhi)
    g0 = starts[:gx, None].long() \
        + torch.arange(mc, device=dev) * CHUNK                 # [gx, mc]
    valid_c = g0 < starts[1:gx + 1, None]

    # Window thresholds in quantized-z space: conservative supersets by
    # monotonicity. Clamp to the finite scene range first (empty chunks
    # carry +-inf); ``zext`` is the exact scene z extent.
    zhi_scene = lo_z + zext
    qlo = _quantize(torch.clamp(lo_chunk - r_max, lo_z, zhi_scene),
                    lo_z, zscale, zmax)
    qhi = _quantize(torch.clamp(hi_chunk + r_max, lo_z, zhi_scene),
                    lo_z, zscale, zmax)

    # One batched composite-key searchsorted for all (offset, lo/hi)
    # thresholds.
    c_idx = torch.arange(gx, device=dev)
    key_q = []
    for dx in SLAB_OFFSETS:
        cb = ((c_idx + dx) << zbits)[:, None]
        key_q += [cb + qlo, cb + qhi + 1]
    all_pos = sorted_bucket_starts(
        key_s, torch.stack(key_q).reshape(-1)).reshape(4, gx, mc)

    w0_list, wcap_list = [], []
    for off, dx in enumerate(SLAB_OFFSETS):
        w0 = all_pos[2 * off]
        wend = all_pos[2 * off + 1]
        if dx == 0:
            # Self slab: the j > i dedup kills everything below the
            # chunk start, so clip the window there.
            w0 = torch.maximum(w0, g0)
        w0 = torch.where(valid_c, w0, 0)
        w0_list.append(w0)
        wcap_list.append(torch.where(valid_c, (wend - w0).clamp_min(0), 0))
    w0_tab = torch.stack(w0_list, -1).reshape(gx, mc * 2).to(torch.int32)
    wcap_tab = torch.stack(wcap_list, -1).reshape(gx, mc * 2) \
        .to(torch.int32)
    rows_rolled = torch.amax((wcap_tab + LANE - 1) // LANE)

    # --- capacity checks (host retry stats; never silently wrong) ---
    max_col = torch.amax(starts[1:gx + 1] - starts[:gx])
    rows_needed = (starts[1:gx + 1] + (LANE - 1)) // LANE \
        - starts[:gx] // LANE
    max_slab = torch.amax(rows_needed)
    ok = (max_col <= col_capacity) & (max_slab + 2 <= slab_rows)

    # Missed-pair threshold of the diagonal count (kernels/slab_sweep.py):
    # a same-slab pair (i, j), j > i + D, overlapping in z implies
    # zlo(i + D + 1) < zhi(i) + r_max + 1/zscale + float32 slop: one
    # quantization cell (the order is zq-sorted, not z-sorted) plus
    # rounding headroom scaled to the scene. Float32 throughout, in the
    # JAX plan's association, so the two agree bit for bit.
    diag_thr = (r_max + _scalar(1.0, zscale) / zscale
                + (lo_z.abs() + zext + r_max) * _scalar(2.0 ** -20, zscale)) \
        .reshape(1)
    return SlabPlan(stream, starts, w0_tab, wcap_tab, ok, max_col,
                    max_slab, rows_rolled, diag_thr, n=n, gx=gx, mc=mc,
                    slab_rows=slab_rows)


def plan_from_numpy(d, device):
    """The port's :class:`SlabPlan` from the JAX ``SlabPlan``'s fields
    given as numpy arrays and ints (``d`` maps field name to value), so
    both packages' kernels can run on one identical plan."""
    def t(name):
        return torch.from_numpy(np.array(d[name])).to(device)

    return SlabPlan(
        t("stream"), t("starts"), t("w0"), t("wcap"), t("ok"),
        t("max_col"), t("max_slab_rows"), t("rows_rolled"), t("diag_thr"),
        n=int(d["n"]), gx=int(d["gx"]), mc=int(d["mc"]),
        slab_rows=int(d["slab_rows"]))


def _residual_mask_tables(stream, starts, w0f, wcf, mc, noff, j_cap,
                          base=1, dmin=0):
    """The [J, 256, 256] overlap mask of every window remainder past the
    first ``base``*128 lanes, plus the per-job id channels.

    Shared by the slab plan (``noff=2``) and the column plan (``noff=5``):
    the flat window tables ``w0f``/``wcf`` are laid out as (bucket * mc +
    k) * noff + off, with ``starts`` indexed by bucket. ``base`` is the
    number of 128-lane rows the paired rolled sweep already covers. Each
    (chunk, offset) window wider than base*128 lanes contributes one job
    per 128-lane segment of its remainder, the job list is compacted to
    ``j_cap`` slots, and each job's lanes [w0 + 128(base+seg),
    min(w0 + wcap, w0 + 128(base+1+seg))) are tested against its whole
    chunk with one dense compare. ``ok`` is False when the job list
    overflowed. ``dmin`` > 0 keeps only the pairs at sorted-index distance
    j - i > dmin (the diagonal count covers the nearer ones).

    Returns (m bool[J, 256, 256], a_idf, b_idf f32[J, 256] — the id
    channel of the fetched a/b lanes — and ok).
    """
    dev = stream.device
    T = w0f.shape[0]

    res = torch.clamp_min(wcf - base * LANE, 0)
    nseg = (res + LANE - 1) // LANE               # 128-lane residual segments
    ic = inclusive_scan(nseg)
    nj = ic[-1]
    ok = nj <= j_cap

    ordj = torch.arange(j_cap, dtype=torch.int32, device=dev)
    sel = torch.clamp_max(sorted_bucket_starts(ic, ordj + 1), T - 1)
    live = ordj < nj
    # Segment index within the owning entry: jobs for entry e occupy
    # ordinals [ic[e] - nseg[e], ic[e]).
    seg = torch.clamp_min(ordj - (ic[sel] - nseg[sel]), 0).long()

    ck = sel // noff                # (bucket, chunk); sel % noff = offset
    x = ck // mc
    k = ck % mc
    g0 = starts[x].long() + k * CHUNK
    aend = starts[x + 1].long()
    # The job's lanes as [w0j + 128, w0j + wcj), w0j pre-shifted past the
    # base rows and the segment.
    shift = (base - 1 + seg) * LANE
    w0j = w0f[sel].long() + shift
    wcj = torch.clamp_max(
        torch.where(live, wcf[sel].long(), 0) - shift, 2 * LANE)

    Rp = stream.shape[0]
    arow = torch.clamp(g0 // LANE, 0, Rp - 2)
    brow = torch.clamp((w0j + LANE) // LANE, 0, Rp - 2)
    rows = torch.stack([arow, arow + 1, brow, brow + 1], dim=1)  # [J, 4]
    quad = stream[rows]                                   # [J, 4, 8, 128]
    lane2 = torch.arange(2 * LANE, device=dev)
    apos = arow[:, None] * LANE + lane2                  # [J, 256]
    jpos = brow[:, None] * LANE + lane2

    def comp(rows2, c):
        return rows2[:, :, c].reshape(-1, 2 * LANE)       # [J, 256]

    a6, b6 = quad[:, :2], quad[:, 2:]
    a_ok = (apos >= g0[:, None]) & (apos < torch.minimum(
        g0 + CHUNK, aend)[:, None])
    b_ok = (jpos >= (w0j + LANE)[:, None]) & (jpos < (w0j + wcj)[:, None])
    # At dmin == 0, j > i holds by construction: self-offset jobs start
    # past the chunk, cross jobs live in a later bucket.
    m = a_ok[:, :, None] & b_ok[:, None, :]
    if dmin:
        m &= jpos[:, None, :] > apos[:, :, None] + dmin
    for lo_c, hi_c in ((0, 3), (1, 4), (2, 5)):
        m &= comp(a6, hi_c)[:, :, None] > comp(b6, lo_c)[:, None, :]
        m &= comp(a6, lo_c)[:, :, None] < comp(b6, hi_c)[:, None, :]
    return m, comp(a6, 6), comp(b6, 6), ok


def _residual_mask(plan, j_cap, base, dmin=0):
    """:func:`_residual_mask_tables` of a slab plan."""
    return _residual_mask_tables(
        plan.stream, plan.starts, plan.w0.reshape(-1), plan.wcap.reshape(-1),
        plan.mc, len(SLAB_OFFSETS), j_cap, base, dmin)


def residual_count(plan, j_cap=RESIDUAL_JOBS, base=1, dmin=0):
    """(int64 count, ok) of the window lanes beyond the first ``base``*128:
    the part of each window that the ``base``-row sweep kernels clip.
    ``dmin`` keeps only pairs at sorted-index distance j - i > dmin, as
    the diagonal count (kernels/slab_sweep.slab_count_diag) needs."""
    m, _, _, ok = _residual_mask(plan, j_cap, base, dmin)
    return m.sum(), ok


def residual_row_mask(plan, p_cap=RESIDUAL_PAIRS, base=1):
    """The residual mask reduced to its hit rows: (small bool[R_cap, 256]
    — the ascending a-rows holding a pair, at most ``p_cap`` —, rowsel,
    a_idf, b_idf, count, ok). Hits are rare by construction, so only
    the hit rows reach the compaction kernel."""
    m, a_idf, b_idf, ok = _residual_mask(plan, RESIDUAL_JOBS, base)
    L2 = 2 * LANE
    mr = m.reshape(-1, L2)                          # [J*256, 256]
    Rm = mr.shape[0]
    rowcnt = mr.sum(dim=1)
    count = rowcnt.sum()
    ok = ok & (count <= p_cap)

    R_cap = min(p_cap, Rm)
    ic = inclusive_scan((rowcnt > 0).to(torch.int32))
    ordr = torch.arange(R_cap, dtype=torch.int32, device=m.device)
    rowsel = torch.clamp_max(sorted_bucket_starts(ic, ordr + 1), Rm - 1)
    small = mr[rowsel] & (ordr < ic[-1])[:, None]
    return small, rowsel, a_idf, b_idf, count, ok


def residual_pairs(plan, p_cap=RESIDUAL_PAIRS, base=1):
    """(ida[p_cap], idb[p_cap], count, ok): original-id pairs of the
    clipped window remainders past ``base``*128 lanes, in ascending (job,
    a-row, lane) order — the fill-side counterpart of
    :func:`residual_count`. Ids are uint32
    values in int64; dead slots hold 0xFFFFFFFF. ``ok`` is False when
    the job list or ``p_cap`` overflowed (the result is then a correct
    prefix)."""
    small, rowsel, a_idf, b_idf, count, ok = residual_row_mask(
        plan, p_cap, base)
    L2 = 2 * LANE
    R_cap = small.shape[0]
    idx, _ = compact.compact_mask(small.reshape(-1), max(p_cap, 8))
    idx = idx[:p_cap]
    live = idx != NO_PAIR
    fl = torch.clamp_max(idx, R_cap * L2 - 1)
    fr = rowsel[fl // L2].long()                  # global (job, a) row
    bi = fl % L2
    ida = _id_values(a_idf.reshape(-1)[fr])
    idb = _id_values(b_idf.reshape(-1)[(fr // L2) * L2 + bi])
    return (torch.where(live, ida, NO_PAIR), torch.where(live, idb, NO_PAIR),
            count, ok)


def _id_values(idf):
    """uint32 ids, as int64, from the stream's id channel bit patterns."""
    return idf.contiguous().view(torch.int32).long() & 0xFFFFFFFF
