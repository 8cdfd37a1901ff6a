"""Slab sweep: pair counts and packed pair masks over a slab plan.

Port of collision_tpu/kernels/slab_sweep.py. The window kernels run the
same tile test: each 64-sphere chunk [g0, min(g0 + 64, a1)) of slab x
against ``rpw`` rolled 128-lane rows of its window in slab x (with j > i)
and in slab x+1, by strict AABB overlap: lane l of row r is sorted sphere
w0 + r*128 + l, in the window iff r*128 + l < wcap. The dual dispatch
runs them at ``base`` rows (1 for the uniform engine, 2 for the hetero
engine's slab pass); window lanes past base*128 are the residual jobs'
(slabs.residual_count / residual_pairs).

The diagonal count (:func:`diag_count`) needs no window tables: it tests
every sorted position i against i+1 .. i+d_max. :func:`slab_count_diag`
adds the cross-slab pairs farther apart than d_max (the window count on
the x+1 offset alone with j > i + d_max, and the residual jobs under the
same mask) and a detector for the same-slab pairs it cannot see. No
``collide`` route takes it: the JAX package measured it slower than the
dual dispatch, and the port keeps its routing.

On a CUDA tensor each wrapper launches its kernel from
``csrc/slab_sweep.cu``; on a CPU tensor it runs the plain PyTorch
version beside it. The window kernels run only the tests that an exact
union-box cull of each 32-row mask word leaves (``csrc/column_tile.cuh``,
shared with the column kernels); counts and words are the plain
versions'. Counts are exact int64, where the JAX kernels return int32
with a float32 twin as their wrap guard.
"""

import torch

from .. import tracing
from ..columns import LANE
from ..slabs import DIAG_B, RESIDUAL_JOBS, residual_count
from . import _build
from .sweep import (INT32_GUARD, mask_groups, tile_count_plain,
                    tile_words_plain)

#: Default diagonal span of :func:`slab_count_diag`. Uniform scenes at
#: the default slab config reach ~12 sorted positions (plan slack 24),
#: so 48 leaves an 8-sigma excursion; anything past it trips the
#: detector (ok=False), never a silent miss.
DEFAULT_DIAG = 48


def _tables(starts, w0, wcap):
    """(gx, mc) of a plan's window tables, checked before a kernel reads
    them."""
    gx, mc2 = w0.shape
    if mc2 % 2 or wcap.shape != w0.shape or starts.numel() < gx + 1:
        raise ValueError(
            f"inconsistent plan tables: starts {tuple(starts.shape)}, "
            f"w0 {tuple(w0.shape)}, wcap {tuple(wcap.shape)}")
    return gx, mc2 // 2


def slab_window_count_plain(stream, starts, w0, wcap, rpw=1, first_off=0,
                            dmin=0):
    """Plain PyTorch version of :func:`slab_window_count`."""
    gx, mc = _tables(starts, w0, wcap)
    return tile_count_plain(stream, starts, w0, wcap, gx, mc, 2, rpw,
                            rolled=True, first_off=first_off, dmin=dmin)


def slab_window_count(stream, starts, w0, wcap, rpw=1, first_off=0, dmin=0):
    """int64 number of set tile-test entries at ``rpw`` rolled rows per
    window (see module docstring), on the offsets from ``first_off`` on
    (0: both; 1: slab x+1 alone), with j > i + ``dmin`` on each offset
    when dmin > 0.

    ``stream`` f32[Rp, 8, 128], ``starts`` int32[gx + 2], ``w0``/``wcap``
    int32[gx, mc*2] of a :class:`~collision_tpu_torch.slabs.SlabPlan`.
    """
    if first_off not in (0, 1) or dmin < 0:
        raise ValueError(f"first_off {first_off} not in (0, 1) or dmin "
                         f"{dmin} < 0")
    if not stream.is_cuda:
        return slab_window_count_plain(stream, starts, w0, wcap, rpw,
                                       first_off, dmin)
    gx, mc = _tables(starts, w0, wcap)
    total = torch.zeros((1,), dtype=torch.int64, device=stream.device)
    _build.launch(
        "slab_count_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(starts, torch.int32, "starts"),
        _build.require(w0, torch.int32, "w0"),
        _build.require(wcap, torch.int32, "wcap"), gx, mc, int(rpw),
        int(first_off), int(dmin), total.data_ptr())
    _build.LAUNCHES["slab_count"] += 1
    return total[0]


def slab_count_guarded(plan, rpw=1):
    """(int64 count, no_wrap): the plan's pair count at ``rpw`` rolled rows
    per window, and False where it reaches ``sweep.INT32_GUARD``. Exact
    iff ``plan.ok`` and ``plan.rows_rolled <= rpw``."""
    count = slab_window_count(plan.stream, plan.starts, plan.w0, plan.wcap,
                              rpw)
    return count, count < INT32_GUARD


def slab_count(plan, rpw=1):
    """int64 pair count of a slab plan at ``rpw`` rolled rows per window:
    exact iff ``plan.ok`` and ``plan.rows_rolled <= rpw``."""
    return slab_count_guarded(plan, rpw)[0]


def slab_masks_plain(stream, starts, w0, wcap, rpw=1):
    """Plain PyTorch version of :func:`slab_masks`."""
    gx, mc = _tables(starts, w0, wcap)
    return tile_words_plain(stream, starts, w0, wcap, gx, mc, 2, rpw,
                            rolled=True)


def slab_masks(stream, starts, w0, wcap, rpw=1):
    """Packed tile masks, int32[gx*NG, KG*2*rpw*2, 128] holding uint32
    words.

    The layout of the JAX ``slab_sweep_masks``, with (KG, NG) =
    ``mask_groups(mc, rpw)``: block x*NG + g, row ((kk*2 + off)*rpw + r)*2
    + h for chunk k = g*KG + kk, lane l = window lane r*128 + l, bit b =
    a-row h*32 + b. Every word is written; dead chunks are 0.
    """
    if not stream.is_cuda:
        return slab_masks_plain(stream, starts, w0, wcap, rpw)
    gx, mc = _tables(starts, w0, wcap)
    kg, ng = mask_groups(mc, rpw)
    out = torch.empty((gx * ng, kg * 2 * rpw * 2, LANE), dtype=torch.int32,
                      device=stream.device)
    _build.launch(
        "slab_masks_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(starts, torch.int32, "starts"),
        _build.require(w0, torch.int32, "w0"),
        _build.require(wcap, torch.int32, "wcap"), gx, mc, int(rpw), kg, ng,
        out.data_ptr())
    _build.LAUNCHES["slab_masks"] += 1
    return out


def slab_count_dual(plan, j_cap=None, split_ok=False, base=1):
    """(int64 count, ok) by dual dispatch: the sweep kernel at ``base``
    rolled rows with windows clamped to base*128 lanes, plus the residual
    jobs for the lanes past them.

    ``ok`` is False when the residual job list (``j_cap`` jobs, default
    ``slabs.RESIDUAL_JOBS``) overflowed or the sweep count reached
    ``sweep.INT32_GUARD``; the count itself is exact in int64.
    ``split_ok`` returns (count, r_ok, no_ovf) instead: r_ok is what a
    finer slab grid can fix, no_ovf the int32 guard, which it cannot.
    """
    wcap_c = torch.clamp_max(plan.wcap, base * LANE)
    with tracing.span("ct.slab.sweep"):
        count = slab_window_count(plan.stream, plan.starts, plan.w0, wcap_c,
                                  rpw=base)
    rcount, r_ok = residual_count(
        plan, RESIDUAL_JOBS if j_cap is None else j_cap, base=base)
    no_ovf = count < INT32_GUARD
    if split_ok:
        return count + rcount, r_ok, no_ovf
    return count + rcount, r_ok & no_ovf


def slab_sweep_masks(plan, rpw=1):
    """Packed tile masks of a plan at ``rpw`` rolled rows per window (see
    :func:`slab_masks`)."""
    return slab_masks(plan.stream, plan.starts, plan.w0, plan.wcap, rpw)


def _diag_positions(stream, d_max):
    """The diagonal count's domain, (Rp - DIAG_B) * 128 sorted positions
    (the JAX kernel's blocks 0 .. Rp/DIAG_B - 2), after checking that the
    stream and ``d_max`` fit it: the detector's reach d_max + 1 stays in
    the one successor block that the JAX kernel reads."""
    rp = stream.shape[0]
    if tuple(stream.shape[1:]) != (8, LANE) or rp % DIAG_B or rp < 2 * DIAG_B:
        raise ValueError(f"stream {tuple(stream.shape)} is not [k*{DIAG_B}, "
                         f"8, {LANE}] with k >= 2")
    if d_max < 0 or d_max + 1 > DIAG_B * LANE:
        raise ValueError(f"d_max {d_max} outside [0, {DIAG_B * LANE - 1}]")
    return (rp - DIAG_B) * LANE


def diag_count_plain(stream, diag_thr, d_max=DEFAULT_DIAG):
    """Plain PyTorch version of :func:`diag_count`."""
    npos = _diag_positions(stream, d_max)
    comps = stream.permute(1, 0, 2).reshape(8, -1)
    a = comps[:, :npos]
    total = torch.zeros((), dtype=torch.int64, device=stream.device)
    for d in range(1, d_max + 1):
        b = comps[:, d:d + npos]
        m = (a[3] > b[0]) & (a[0] < b[3])
        m &= (a[4] > b[1]) & (a[1] < b[4])
        m &= (a[5] > b[2]) & (a[2] < b[5])
        total += m.sum()
    b = comps[:, d_max + 1:d_max + 1 + npos]
    flagged = ((b[7] == a[7]) & (b[2] < a[5] + diag_thr[0])).sum()
    return total, flagged


def diag_count(stream, diag_thr, d_max=DEFAULT_DIAG):
    """(int64 count, int64 flagged) over all pairs (i, i+d), 1 <= d <=
    ``d_max``, of the sorted stream f32[Rp, 8, 128], by strict AABB
    overlap: every pair within d_max sorted positions, same slab or
    adjacent slab, once.

    ``flagged`` counts the positions i whose partner at d_max + 1 is in
    the same slab (channel 7) with zlo below zhi(i) + ``diag_thr`` (f32[1],
    ``SlabPlan.diag_thr``): where it is not 0, some same-slab pair past
    d_max may exist, and the count is a lower bound.
    """
    d_max = int(d_max)
    if not stream.is_cuda:
        return diag_count_plain(stream, diag_thr, d_max)
    npos = _diag_positions(stream, d_max)
    out = torch.zeros((2,), dtype=torch.int64, device=stream.device)
    _build.launch(
        "diag_count_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(diag_thr, torch.float32, "diag_thr"), npos, d_max,
        out.data_ptr())
    _build.LAUNCHES["diag_count"] += 1
    return out[0], out[1]


def slab_count_diag(plan, d_max=DEFAULT_DIAG, j_cap=None):
    """(int64 count, ok): the diagonal count plus the cross-slab pairs
    past it.

    The pairs partition by sorted-index distance d = j - i:

      d <= d_max              :func:`diag_count`, any slab;
      d >  d_max, cross-slab  the window count on offset x+1 alone, one
                              rolled row with windows clamped to 128
                              lanes and the ``j > i + d_max`` mask, plus
                              the residual jobs (``j_cap``, default
                              ``slabs.RESIDUAL_JOBS``) under the same mask;
      d >  d_max, same-slab   nobody: the detector flags them.

    ``ok`` is False when the detector flagged, the residual job list
    overflowed, or the diagonal and window counts reached
    ``sweep.INT32_GUARD``; the count is then a lower bound.
    """
    dcount, flagged = diag_count(plan.stream, plan.diag_thr, d_max)
    ccount = slab_window_count(plan.stream, plan.starts, plan.w0,
                               torch.clamp_max(plan.wcap, LANE), rpw=1,
                               first_off=1, dmin=d_max)
    rcount, r_ok = residual_count(
        plan, RESIDUAL_JOBS if j_cap is None else j_cap, dmin=d_max)
    ok = r_ok & (dcount + ccount < INT32_GUARD) & (flagged == 0)
    return dcount + ccount + rcount, ok
