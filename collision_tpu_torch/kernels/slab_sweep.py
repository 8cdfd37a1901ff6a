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

from ..columns import CHUNK, LANE
from . import _build
from .sweep import mask_groups


def _tile_masks(comps, starts, w0, wcap, x0, x1):
    """bool[x1-x0, mc, 2, 64, 128]: the tile test of slabs [x0, x1).

    Entry [x, k, off, a, l] is set iff sorted sphere g0 + a of chunk k
    (g0 = starts[x] + 64k, a-row inside the slab) strictly overlaps
    window lane l of offset ``off`` (j = w0 + l, l < min(wcap, 128)),
    and j > i for the self offset. ``comps`` is the stream's six box
    channels, flattened to [6, Rp*128].
    """
    dev = comps.device
    npos = comps.shape[1]
    mc = w0.shape[1] // 2
    bx = x1 - x0
    g0 = starts[x0:x1, None].long() \
        + torch.arange(mc, device=dev) * CHUNK                  # [bx, mc]
    i = g0[..., None] + torch.arange(CHUNK, device=dev)          # [bx, mc, 64]
    a_ok = i < starts[x0 + 1:x1 + 1, None, None]
    w0 = w0[x0:x1].view(bx, mc, 2).long()
    wc = torch.clamp_max(wcap[x0:x1].view(bx, mc, 2), LANE)
    lanes = torch.arange(LANE, device=dev)
    j = w0[..., None] + lanes                                     # [bx, mc, 2, 128]
    a = comps[:, i.clamp(max=npos - 1)][:, :, :, None, :, None]
    b = comps[:, j.clamp(max=npos - 1)][:, :, :, :, None, :]
    m = a_ok[:, :, None, :, None] & (lanes < wc[..., None])[:, :, :, None, :]
    for lo_c, hi_c in ((0, 3), (1, 4), (2, 5)):
        m &= (a[hi_c] > b[lo_c]) & (a[lo_c] < b[hi_c])
    m[:, :, 0] &= j[:, :, 0, None, :] > i[..., None]
    return m


def _tile_batches(stream, starts, w0, wcap):
    """Yield the tile masks slab batch by slab batch (bounded memory)."""
    comps = stream[:, :6, :].permute(1, 0, 2).reshape(6, -1)
    gx, mc = w0.shape[0], w0.shape[1] // 2
    step = max(1, (1 << 25) // (mc * 2 * CHUNK * LANE))
    for x0 in range(0, gx, step):
        yield _tile_masks(comps, starts, w0, wcap, x0, min(gx, x0 + step))


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
    total = torch.zeros((), dtype=torch.int64, device=stream.device)
    for m in _tile_batches(stream, starts, w0, wcap):
        total += m.sum()
    return total


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
    mc = w0.shape[1] // 2
    kg, ng = mask_groups(mc)
    dev = stream.device
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))[:, None]
    out = []
    for m in _tile_batches(stream, starts, w0, wcap):
        bx = m.shape[0]
        # [bx, mc, off, h, bit, lane] -> words [bx, mc, off, h, lane]
        words = (m.view(bx, mc, 2, 2, 32, LANE).long() * weights).sum(-2)
        words = torch.cat([words, words.new_zeros(
            (bx, ng * kg - mc, 2, 2, LANE))], dim=1)
        out.append(words.reshape(bx * ng, kg * 4, LANE))
    words = torch.cat(out)
    # uint32 bit patterns stored as int32.
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def slab_masks(stream, starts, w0, wcap):
    """Packed tile masks, int32[gx*NG, KG*4, 128] holding uint32 words.

    The layout of the JAX ``slab_sweep_masks`` at one rolled row per
    window, with (KG, NG) = ``mask_groups(mc)``: block x*NG + g, row
    (kk*2 + off)*2 + h for chunk k = g*KG + kk, lane l = window lane l,
    bit b = a-row h*32 + b. Every word is written; dead chunks are 0.
    """
    if not stream.is_cuda:
        return slab_masks_plain(stream, starts, w0, wcap)
    gx, mc = _tables(starts, w0, wcap)
    kg, ng = mask_groups(mc)
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
    reached the JAX package's int32 guard (2^31 - 2^26); the count itself
    is exact in int64.
    """
    from ..slabs import residual_count

    count = slab_count(plan.stream, plan.starts, plan.w0, plan.wcap)
    rcount, r_ok = residual_count(plan)
    count = count + rcount
    return count, r_ok & (count < 2 ** 31 - 2 ** 26)


def slab_sweep_masks(plan):
    """Packed tile masks of a plan at one row per window (see
    :func:`slab_masks`)."""
    return slab_masks(plan.stream, plan.starts, plan.w0, plan.wcap)
