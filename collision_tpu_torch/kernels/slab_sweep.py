"""Slab sweep: pair count and packed pair masks over a slab plan.

Port of collision_tpu/kernels/slab_sweep.py. Both kernels run the same
tile test: each 64-sphere chunk [g0, min(g0 + 64, a1)) of slab x against
the first ``min(wcap, 128)`` lanes of its window in slab x (with j > i)
and in slab x+1, by strict AABB overlap. Window lanes past 128 are the
residual jobs' (slabs.residual_count / residual_pairs).

On a CUDA tensor each wrapper launches its kernel from
``csrc/slab_sweep.cu``; on a CPU tensor it runs the plain PyTorch
version beside it.
"""

import torch

from ..columns import LANE
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


def slab_count_plain(stream, starts, w0, wcap):
    """Plain PyTorch version of :func:`slab_count`."""
    gx, mc = _tables(starts, w0, wcap)
    return tile_count_plain(stream, starts, w0, wcap, gx, mc, 2, 1,
                            rolled=True)


def slab_count(stream, starts, w0, wcap):
    """int64 number of set tile-test entries (see module docstring).

    ``stream`` f32[Rp, 8, 128], ``starts`` int32[gx + 2], ``w0``/``wcap``
    int32[gx, mc*2] of a :class:`~collision_tpu_torch.slabs.SlabPlan`.
    """
    if not stream.is_cuda:
        return slab_count_plain(stream, starts, w0, wcap)
    gx, mc = _tables(starts, w0, wcap)
    total = torch.zeros((1,), dtype=torch.int64, device=stream.device)
    _build.launch(
        "slab_count_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(starts, torch.int32, "starts"),
        _build.require(w0, torch.int32, "w0"),
        _build.require(wcap, torch.int32, "wcap"), gx, mc, total.data_ptr())
    _build.LAUNCHES["slab_count"] += 1
    return total[0]


def slab_masks_plain(stream, starts, w0, wcap):
    """Plain PyTorch version of :func:`slab_masks`."""
    gx, mc = _tables(starts, w0, wcap)
    return tile_words_plain(stream, starts, w0, wcap, gx, mc, 2, 1,
                            rolled=True)


def slab_masks(stream, starts, w0, wcap):
    """Packed tile masks, int32[gx*NG, KG*4, 128] holding uint32 words.

    The layout of the JAX ``slab_sweep_masks`` at one rolled row per
    window, with (KG, NG) = ``mask_groups(mc, rpw=1)``: block x*NG + g, row
    (kk*2 + off)*2 + h for chunk k = g*KG + kk, lane l = window lane l,
    bit b = a-row h*32 + b. Every word is written; dead chunks are 0.
    """
    if not stream.is_cuda:
        return slab_masks_plain(stream, starts, w0, wcap)
    gx, mc = _tables(starts, w0, wcap)
    kg, ng = mask_groups(mc, rpw=1)
    out = torch.empty((gx * ng, kg * 4, LANE), dtype=torch.int32,
                      device=stream.device)
    _build.launch(
        "slab_masks_launch",
        _build.require(stream, torch.float32, "stream"),
        _build.require(starts, torch.int32, "starts"),
        _build.require(w0, torch.int32, "w0"),
        _build.require(wcap, torch.int32, "wcap"), gx, mc, kg, ng,
        out.data_ptr())
    _build.LAUNCHES["slab_masks"] += 1
    return out


def slab_count_dual(plan):
    """(int64 count, ok) by dual dispatch: the one-row sweep kernel plus
    the residual jobs for window lanes past 128.

    ``ok`` is False when the residual job list overflowed or the count
    reached ``sweep.INT32_GUARD``; the count itself is exact in int64.
    """
    from ..slabs import residual_count

    count = slab_count(plan.stream, plan.starts, plan.w0, plan.wcap)
    rcount, r_ok = residual_count(plan)
    count = count + rcount
    return count, r_ok & (count < INT32_GUARD)


def slab_sweep_masks(plan):
    """Packed tile masks of a plan at one row per window (see
    :func:`slab_masks`)."""
    return slab_masks(plan.stream, plan.starts, plan.w0, plan.wcap)
