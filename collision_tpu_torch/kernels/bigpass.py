"""Big-sphere pass: the hetero engine's big set against every stream row.

Port of collision_tpu/kernels/bigpass.py. The big set is a table of
64-sphere chunks (``hetero._bigs_table``: rows f32[nbc, 64, 8], per-chunk
z extents zlo/zhi f32[nbc]); chunk 0 holds the 64 largest radii and is
tested against every stream row, the other chunks are z-sorted and each
row tests only the run [c0, c1) whose z extents can meet its own
(:func:`_row_ranges`, a conservative superset). The test is the strict
a.hi > b.lo && a.lo < b.hi on each axis, a = big, b = stream lane. The
stream is a parked plan's: big spheres carry empty [+inf, -inf] boxes
there, so no big-big pair appears, and each big-small pair appears once,
with the big on the a side. Pad rows and lanes are all +inf and hit
nothing.

On a CUDA tensor each wrapper launches its kernels from
``csrc/bigpass.cu``; on a CPU tensor it runs the plain PyTorch version
beside it. Both kernels (the count, also the first pass of
``big_pairs``, and the emission) test a big against a row's lanes only
if it meets the row's union box, an exact cull; the emission skips the
rows the count found empty. The JAX
package pads the stream to 256-row blocks for its grid; the port does
not (pad rows hit nothing and emit nothing).
"""

import torch

from ..columns import CHUNK, LANE
from ..slabs import NO_PAIR
from . import _build
from .sweep import INT32_GUARD


def _row_ranges(stream, zlo, zhi):
    """(c0 int32[Rp], c1 int32[Rp], n_always): for each stream row the
    absolute big-chunk range [c0, c1) that can meet its z extent, and the
    number of always-tested leading chunks (the giants).

    Two monotone envelopes over the z-sorted chunks past the giants, the
    prefix max of zhi and the suffix min of zlo, turn each row's range
    into two searchsorted lookups. Pad rows (zlo = +inf) get empty
    ranges; c1 >= c0 always.
    """
    nbc = zlo.shape[0]
    n_always = 1 if nbc > 1 else nbc
    zlo_rows = stream[:, 2, :].amin(dim=1)
    zhi_rows = stream[:, 5, :].amax(dim=1)
    if nbc == n_always:
        c0 = torch.full(zlo_rows.shape, n_always, dtype=torch.int32,
                        device=stream.device)
        return c0, c0.clone(), n_always
    hi_env = torch.cummax(zhi[n_always:], dim=0).values
    lo_env = torch.cummin(zlo[n_always:].flip(0), dim=0).values.flip(0)
    c0 = n_always + torch.searchsorted(hi_env, zlo_rows, right=True,
                                       out_int32=True)
    c1 = n_always + torch.searchsorted(lo_env.contiguous(), zhi_rows,
                                       out_int32=True)
    return c0, torch.maximum(c1, c0), n_always


def _tile_hits_plain(rows, c0, c1, n_always, stream, r0, r1):
    """bool[r1-r0, nbc, 64, 128]: entry [r, c, a, l] is set iff big a of
    chunk c strictly overlaps lane l of stream row r0 + r and row r0 + r
    visits chunk c."""
    dev = stream.device
    b = stream[r0:r1, :6, :]                                 # [R, 6, 128]
    a = rows[:, :, :6]                                       # [nbc, 64, 6]
    m = torch.ones((r1 - r0, a.shape[0], CHUNK, LANE), dtype=torch.bool,
                   device=dev)
    for lo_c, hi_c in ((0, 3), (1, 4), (2, 5)):
        m &= a[None, :, :, hi_c, None] > b[:, None, None, lo_c, :]
        m &= a[None, :, :, lo_c, None] < b[:, None, None, hi_c, :]
    c = torch.arange(a.shape[0], device=dev)
    visit = (c < n_always) | ((c >= c0[r0:r1, None]) & (c < c1[r0:r1, None]))
    return m & visit[:, :, None, None]


def _row_batches(rows, stream):
    """Stream row batches of the plain versions (bounded memory)."""
    step = max(1, (1 << 25) // (rows.shape[0] * CHUNK * LANE))
    Rp = stream.shape[0]
    return [(r0, min(Rp, r0 + step)) for r0 in range(0, Rp, step)]


def count_launch(bigs, stream, counts, total):
    """Launch the big count kernel on a CUDA stream tensor: each row's
    int32 count into ``counts`` (int32[Rp], or None) and their sum added
    to ``total`` (int64[1], or None). Returns the row ranges (c0, c1,
    n_always) it launched with. Counts no launch: the callers do."""
    rows, zlo, zhi = bigs
    c0, c1, n_always = _row_ranges(stream, zlo, zhi)
    _build.launch(
        "big_count_launch", _build.require(rows, torch.float32, "bigs"),
        c0.data_ptr(), c1.data_ptr(), n_always,
        _build.require(stream, torch.float32, "stream"), stream.shape[0],
        None if counts is None else counts.data_ptr(),
        None if total is None else total.data_ptr())
    return c0, c1, n_always


def big_count_only_plain(bigs, stream):
    """Plain PyTorch version of :func:`big_count_only`."""
    rows, zlo, zhi = bigs
    c0, c1, n_always = _row_ranges(stream, zlo, zhi)
    total = torch.zeros((), dtype=torch.int64, device=stream.device)
    for r0, r1 in _row_batches(rows, stream):
        total += _tile_hits_plain(rows, c0, c1, n_always, stream, r0, r1).sum()
    return total, total < INT32_GUARD


def big_count_only(bigs, stream):
    """(int64 total, no_overflow): the number of (big, stream sphere)
    overlaps. ``bigs`` is ``hetero._bigs_table``'s (rows, zlo, zhi),
    ``stream`` f32[Rp, 8, 128] a parked plan's stream. ``no_overflow`` is
    False from the JAX package's int32 guard up; the total is exact."""
    if not stream.is_cuda:
        return big_count_only_plain(bigs, stream)
    total = torch.zeros((1,), dtype=torch.int64, device=stream.device)
    count_launch(bigs, stream, None, total)
    _build.LAUNCHES["big_count"] += 1
    return total[0], total[0] < INT32_GUARD


def big_pairs_plain(bigs, stream, capacity):
    """Plain PyTorch version of :func:`big_pairs`."""
    rows, zlo, zhi = bigs
    c0, c1, n_always = _row_ranges(stream, zlo, zhi)
    dev = stream.device
    big_ids = rows[:, :, 6].contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF                                          # [nbc, 64]
    lane_ids = stream[:, 6, :].contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF                                          # [Rp, 128]
    ida = torch.full((capacity,), NO_PAIR, dtype=torch.int64, device=dev)
    idb = ida.clone()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for r0, r1 in _row_batches(rows, stream):
        m = _tile_hits_plain(rows, c0, c1, n_always, stream, r0, r1)
        # Emission order: row, chunk (visit order is ascending chunk
        # index), word h, lane, bit, as the kernel's ranks.
        m = m.view(r1 - r0, -1, 2, 32, LANE).permute(0, 1, 2, 4, 3)
        hit = torch.nonzero(m)                        # [k, 5], ascending
        slot0 = int(total)
        total += hit.shape[0]
        take = hit[:max(0, min(hit.shape[0], capacity - slot0))]
        if take.shape[0]:
            r, c, h, lane, bit = take.unbind(1)
            q = slice(slot0, slot0 + take.shape[0])
            ida[q] = big_ids[c, h * 32 + bit]
            idb[q] = lane_ids[r0 + r, lane]
    return ida, idb, total, total < INT32_GUARD


def big_pairs(bigs, stream, capacity):
    """(ida[capacity], idb[capacity], int64 total, no_overflow): the
    (big, stream sphere) pairs, ``ida`` always the big's original id.

    Pairs come in the JAX kernel's order: stream rows ascending; within a
    row the chunks in visit order (the giants, then [c0, c1)); within a
    tile word h = 0 (a-rows 0-31) before h = 1, lanes ascending, bits
    ascending. Ids are uint32 values in int64; slots past the true total
    hold 0xFFFFFFFF. ``total`` is the true count even past ``capacity``.
    """
    if not stream.is_cuda:
        return big_pairs_plain(bigs, stream, capacity)
    dev = stream.device
    nrows = stream.shape[0]
    counts = torch.empty((nrows,), dtype=torch.int32, device=dev)
    total = torch.zeros((1,), dtype=torch.int64, device=dev)
    ida = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    idb = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    c0, c1, n_always = count_launch(bigs, stream, counts, total)
    # Each row's first slot: the exclusive scan of the row counts, queued
    # on the stream (no host sync).
    bases = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    _build.launch("big_emit_launch", bigs[0].data_ptr(), c0.data_ptr(),
                  c1.data_ptr(), n_always, stream.data_ptr(), nrows,
                  counts.data_ptr(), bases.data_ptr(), capacity,
                  ida.data_ptr(), idb.data_ptr())
    _build.LAUNCHES["big_pairs"] += 1
    return (ida.long() & 0xFFFFFFFF, idb.long() & 0xFFFFFFFF, total[0],
            total[0] < INT32_GUARD)
