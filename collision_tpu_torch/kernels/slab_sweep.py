"""Slab sweep: pair count and packed pair masks over a slab plan.

Port of collision_tpu/kernels/slab_sweep.py. Both kernels run the same
tile test: each 64-sphere chunk [g0, min(g0 + 64, a1)) of slab x against
``rpw`` rolled 128-lane rows of its window in slab x (with j > i) and in
slab x+1, by strict AABB overlap: lane l of row r is sorted sphere
w0 + r*128 + l, in the window iff r*128 + l < wcap. The dual dispatch
runs them at ``base`` rows (1 for the uniform engine, 2 for the hetero
engine's slab pass); window lanes past base*128 are the residual jobs'
(slabs.residual_count / residual_pairs).

On a CUDA tensor each wrapper launches its kernel from
``csrc/slab_sweep.cu``; on a CPU tensor it runs the plain PyTorch
version beside it.
"""

import torch

from ..columns import LANE
from ..slabs import RESIDUAL_JOBS, residual_count
from . import _build
from .sweep import (INT32_GUARD, mask_groups, tile_count_plain,
                    tile_words_plain)


def _tables(starts, w0, wcap):
    """(gx, mc) of a plan's window tables, checked before a kernel reads
    them."""
    gx, mc2 = w0.shape
    if mc2 % 2 or wcap.shape != w0.shape or starts.numel() < gx + 1:
        raise ValueError(
            f"inconsistent plan tables: starts {tuple(starts.shape)}, "
            f"w0 {tuple(w0.shape)}, wcap {tuple(wcap.shape)}")
    return gx, mc2 // 2


def slab_count_plain(stream, starts, w0, wcap, rpw=1):
    """Plain PyTorch version of :func:`slab_count`."""
    gx, mc = _tables(starts, w0, wcap)
    return tile_count_plain(stream, starts, w0, wcap, gx, mc, 2, rpw,
                            rolled=True)


def slab_count(stream, starts, w0, wcap, rpw=1):
    """int64 number of set tile-test entries at ``rpw`` rolled rows per
    window (see module docstring).

    ``stream`` f32[Rp, 8, 128], ``starts`` int32[gx + 2], ``w0``/``wcap``
    int32[gx, mc*2] of a :class:`~collision_tpu_torch.slabs.SlabPlan`.
    """
    if not stream.is_cuda:
        return slab_count_plain(stream, starts, w0, wcap, rpw)
    gx, mc = _tables(starts, w0, wcap)
    total = torch.zeros((1,), dtype=torch.int64, device=stream.device)
    _build.launch(
        "slab_count_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(starts, torch.int32, "starts"),
        _build.require(w0, torch.int32, "w0"),
        _build.require(wcap, torch.int32, "wcap"), gx, mc, int(rpw),
        total.data_ptr())
    _build.LAUNCHES["slab_count"] += 1
    return total[0]


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
    count = slab_count(plan.stream, plan.starts, plan.w0, wcap_c, rpw=base)
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
