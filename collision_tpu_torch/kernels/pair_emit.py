"""Pair emission from packed sweep masks, at any capacity.

Port of collision_tpu/kernels/pair_emit.py. The masks are a sweep
kernel's packed tile masks in their native layout, B[NB, 2*KGT, 128]
(``sweep.sweep_masks`` or ``slab_sweep.slab_masks``): bit ``b`` of lane
``l`` of mask row ``(nb, 2*sl + h)`` is the sorted pair
``(cb_tab[nb, sl] + h*32 + b, wstart_tab[nb, sl] + l)``, and
``ids_flat`` maps sorted positions to original ids. The pairs come out in
ascending (mask row, lane, bit) order, the first ``capacity`` of them.

On a CUDA tensor :func:`emit_pair_buffer` launches the kernel of
``csrc/pair_emit.cu``, which writes the int64 ``[capacity, 2]`` pair
buffer of a collision result in place, and :func:`row_popcounts` (the
row table the emission starts from, which the fills compute anyway) that
file's row count kernel; on a CPU tensor they run
:func:`emit_pair_buffer_plain` over :func:`emit_pairs_plain`, the blocked
emission of the JAX package's ``fill._mask_fill_emit_big``, and
:func:`row_popcounts_plain`. :func:`emit_pairs` keeps the JAX package's
signature and its ``(ida, idb)`` return: the two columns of that buffer,
as views. The JAX kernel's ``mxu`` and ``nostore`` variants are TPU perf
knobs and are not ported.

Ids are uint32 values held in int64 (int32 bit patterns are accepted as
input); slots past the last pair hold 0xFFFFFFFF.
"""

import torch

from ..columns import LANE
from ..slabs import NO_PAIR
from ..ops import sorted_bucket_starts
from . import _build

#: Output slots per block of the plain version: [blk, 128] int64
#: temporaries, 64 MiB each.
EMIT_BLK = 1 << 16

#: Mask rows per pass of :func:`row_popcounts_plain` (bounds its int64
#: temporaries at 512 MiB).
_POPCOUNT_ROWS = 1 << 19


def popcount(w):
    """Set bits of each uint32 value held in an int64 tensor (SWAR: torch
    has no popcount op)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) >> 24) & 0xFF


def select_bit(word, rank):
    """Index of the ``rank``-th set bit of ``word`` (binary partition by
    popcount, five rounds)."""
    pos = torch.zeros_like(word)
    rem = rank
    for width in (16, 8, 4, 2, 1):
        c = popcount(word & (((1 << width) - 1) << pos))
        right = c <= rem
        rem = torch.where(right, rem - c, rem)
        pos = torch.where(right, pos + width, pos)
    return pos


def _words(w):
    """uint32 words held in int32 as their int64 values."""
    return w.view(torch.uint32).long()


def row_words(B, rows):
    """Mask rows ``rows`` of ``B`` as int64 words [len(rows), 128]."""
    return _words(B.reshape(-1, LANE)[rows])


def row_popcounts_plain(B):
    """Plain PyTorch version of :func:`row_popcounts`: a SWAR popcount of
    the int64 words, in passes of ``_POPCOUNT_ROWS`` rows, so no int64
    copy of the whole buffer is made."""
    Bv = B.reshape(-1, LANE)
    return torch.cat([
        popcount(_words(Bv[r0:r0 + _POPCOUNT_ROWS])).sum(dim=1)
        for r0 in range(0, Bv.shape[0], _POPCOUNT_ROWS)])


def row_popcounts(B):
    """int64 set bits of each 128-word row of a mask buffer (int32 uint32
    words, any shape whose last dimension is 128): on a CUDA tensor the
    ``__popc`` kernel of ``csrc/pair_emit.cu``, one warp a row."""
    if not B.is_cuda:
        return row_popcounts_plain(B)
    if B.shape[-1] != LANE:
        raise ValueError(f"mask rows are {LANE} words, got {tuple(B.shape)}")
    rows = B.numel() // LANE
    counts = torch.empty((rows,), dtype=torch.int64, device=B.device)
    if not rows:
        return counts
    _build.launch("row_popcount_launch",
                  _build.require(B, torch.int32, "masks"), rows,
                  counts.data_ptr())
    _build.LAUNCHES["row_popcounts"] += 1
    return counts


def _tables(B, wstart_tab, cb_tab):
    """(flat int64 wstart, flat int64 cb), checked against B's shape."""
    NB, rb2, lanes = B.shape
    if rb2 % 2 or lanes != LANE or wstart_tab.numel() != NB * rb2 // 2 \
            or cb_tab.numel() != wstart_tab.numel():
        raise ValueError(
            f"inconsistent emission tables: masks {tuple(B.shape)}, wstart "
            f"{tuple(wstart_tab.shape)}, cb {tuple(cb_tab.shape)}")
    return (wstart_tab.reshape(-1).long().contiguous(),
            cb_tab.reshape(-1).long().contiguous())


def emit_pairs_plain(B, wstart_tab, cb_tab, ids_flat, capacity, rp_tab=None,
                     blk=EMIT_BLK):
    """Plain PyTorch version of :func:`emit_pairs`, ``blk`` slots at a
    time.

    Each output slot finds its mask row by a searchsorted into the rows'
    cumulative popcounts, its lane by the row's lane prefix sum, its bit
    by rank-select, and both ids by two gathers. The JAX package's TPU
    machinery for this (the run-expansion tables that replace per-slot
    searches, the interleaved [rows, 384] fetch table and its
    ``_WIDE_ROWS_CAP``, the lane prefix as a matmul) exists because
    scalar gathers are slow on a TPU, and is not ported.
    """
    ws, cb = _tables(B, wstart_tab, cb_tab)
    dev = B.device
    rp = row_popcounts(B) if rp_tab is None else rp_tab.reshape(-1).long()
    csum = torch.cumsum(rp, 0)
    ids = ids_flat.reshape(-1).long() & 0xFFFFFFFF
    nsort = ids.shape[0]
    ida = torch.full((capacity,), NO_PAIR, dtype=torch.int64, device=dev)
    idb = ida.clone()
    lim = min(int(csum[-1]), capacity) if csum.numel() else 0
    for q0 in range(0, lim, blk):
        q = torch.arange(q0, min(q0 + blk, lim), device=dev)
        R = sorted_bucket_starts(csum, q + 1)          # first csum > q
        rem = q - (csum[R] - rp[R])                    # rank within the row
        m = row_words(B, R)                            # [blk, 128]
        wpc = popcount(m)
        lane_cum = torch.cumsum(wpc, dim=1)
        lane = (lane_cum <= rem[:, None]).sum(dim=1)
        word = m.gather(1, lane[:, None])[:, 0]
        before = (lane_cum - wpc).gather(1, lane[:, None])[:, 0]
        bit = select_bit(word, rem - before)
        g = R // 2
        i = cb[g] + (R % 2) * 32 + bit
        j = ws[g] + lane
        ida[q] = ids[i.clamp(0, nsort - 1)]
        idb[q] = ids[j.clamp(0, nsort - 1)]
    return ida, idb


def emit_pair_buffer_plain(B, wstart_tab, cb_tab, ids_flat, capacity,
                           rp_tab=None):
    """Plain PyTorch version of :func:`emit_pair_buffer`: the columns of
    :func:`emit_pairs_plain`, stacked."""
    return torch.stack(emit_pairs_plain(B, wstart_tab, cb_tab, ids_flat,
                                        capacity, rp_tab), 1)


def emit_pair_buffer(B, wstart_tab, cb_tab, ids_flat, capacity, rp_tab=None):
    """pairs int64[capacity, 2], contiguous: the first min(total,
    capacity) pairs of the packed masks in ascending (mask row, lane, bit)
    order, as original ids (a, b); the other slots hold 0xFFFFFFFF.

    Args:
      B: int32[NB, 2*KGT, 128] packed masks (uint32 words).
      wstart_tab: [NB, KGT] sorted start of each row group's 128-lane
        window (any alignment: the rolled and the aligned layouts both
        reduce to it).
      cb_tab: [NB, KGT] sorted start of each row group's 64-sphere chunk.
      ids_flat: [nsort] original ids in sorted order.
      capacity: output slots (>= 0).
      rp_tab: optional [NB, 2*KGT] popcount of each mask row, when the
        caller has it already.

    The JAX kernel keeps the sorted ids resident in VMEM, so the JAX fill
    takes it only up to ``KERNEL_EMIT_MAX_IDS`` spheres; the card has no
    such limit.
    """
    if not B.is_cuda:
        return emit_pair_buffer_plain(B, wstart_tab, cb_tab, ids_flat,
                                      capacity, rp_tab)
    ws, cb = _tables(B, wstart_tab, cb_tab)
    dev = B.device
    pairs = torch.empty((capacity, 2), dtype=torch.int64, device=dev)
    if not capacity:
        return pairs
    rows = B.shape[0] * B.shape[1]
    rp = row_popcounts(B) if rp_tab is None else rp_tab.reshape(-1)
    # Each row's end slot: the inclusive scan of the row popcounts, queued
    # on the stream (no host sync).
    ends = torch.cumsum(rp, 0, dtype=torch.int64)
    ids = ids_flat.reshape(-1)
    if ids.dtype != torch.int64:
        ids = ids.long() & 0xFFFFFFFF
    ids = ids.contiguous()
    _build.launch(
        "pair_emit_launch", _build.require(B, torch.int32, "masks"),
        _build.require(ws, torch.int64, "wstart_tab"),
        _build.require(cb, torch.int64, "cb_tab"),
        _build.require(ids, torch.int64, "ids"), ids.shape[0],
        _build.require(ends, torch.int64, "row ends"), rows, capacity,
        pairs.data_ptr())
    _build.LAUNCHES["pair_emit"] += 1
    return pairs


def emit_pairs(B, wstart_tab, cb_tab, ids_flat, capacity, rp_tab=None):
    """(ida int64[capacity], idb int64[capacity]): the JAX package's form
    of :func:`emit_pair_buffer`, whose two columns they are, as views."""
    pairs = emit_pair_buffer(B, wstart_tab, cb_tab, ids_flat, capacity,
                             rp_tab)
    return pairs[:, 0], pairs[:, 1]
