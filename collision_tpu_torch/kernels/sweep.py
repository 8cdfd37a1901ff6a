"""Column sweep: pair count and packed pair masks over a column plan.

Port of collision_tpu/kernels/sweep.py. Every kernel runs the same tile
test: each 64-sphere chunk [g0, min(g0 + 64, a1)) of column c against
``rpw`` 128-lane rows of its window in each of the 5 half-stencil
columns, by strict AABB overlap, with j > i on the self offset. The row
addressing differs:

- aligned rows (``rolled=False``, the count's default and the masks):
  lane l of row r is sorted sphere j = (w0 // 128 + r) * 128 + l, in the
  window iff w0 <= j < w0 + wcap; exact iff ``plan.rows_needed <= rpw``;
- rolled rows (``rolled=True``, the column engine's count): lane l of
  row r is j = w0 + r * 128 + l, in the window iff r * 128 + l < wcap;
  exact iff ``plan.rows_rolled <= rpw``.

On a CUDA tensor each wrapper launches its kernel from ``csrc/sweep.cu``;
on a CPU tensor it runs the plain PyTorch version beside it. ``rpw`` is
a runtime loop bound in the kernels, so the JAX package's TPU-only
knobs are not ported: ``ROWS_STATIC_MAX`` and ``_ROW_UNIT_BUDGET`` (the
Mosaic scoped-VMEM budget for unrolled rows) and ``UNROLL`` (the TPU's
chunk unrolling). ``RPW_LADDER`` is kept as routing data: the hetero
route (``collider._hetero_route_knobs``) picks its rows-per-window rung
from it.

``sweep_count_dual`` is the hetero engine's column S-S count: the rolled
kernel at ``base`` rows plus the residual jobs (``slabs``) for the window
lanes past them.
"""

import numpy as np
import torch

from .. import tracing
from ..columns import CHUNK, LANE
from ..slabs import RESIDUAL_JOBS, _residual_mask_tables
from . import _build

#: Half-stencil offsets per chunk (``columns.COLUMN_OFFSETS``).
NOFF = 5

#: Rows-per-window rungs of the JAX package's retry ladder.
RPW_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)

#: The JAX package keeps pair totals in int32 and flags them (ok=False)
#: from 2^31 - 2^26 up; the port's totals are exact int64, held to the
#: same bound.
INT32_GUARD = 2 ** 31 - 2 ** 26


def mask_groups(mc, rpw):
    """(KG, NG): chunks per mask group and number of groups.

    The layout of the packed mask buffers, kept from the JAX package so
    the buffers compare bit for bit: KG is at most ~2 MiB of words per
    group on the TPU, rounded up to a multiple of 4. The slab engine's
    one-row masks use ``rpw=1``.
    """
    kg = max(1, (2 << 20) // (5 * rpw * 1024))
    kg = min(kg, mc)
    kg = -(-kg // 4) * 4
    return kg, -(-mc // kg)


def _tables(plan):
    """(ncols, mc) of a column plan's tables, checked before a kernel
    reads them."""
    gxy, mc = plan.gxy, plan.mc
    shape = (gxy, gxy * mc * NOFF)
    if (tuple(plan.w0.shape) != shape or tuple(plan.wcap.shape) != shape
            or plan.starts.numel() < gxy * gxy + 1):
        raise ValueError(
            f"inconsistent column plan: gxy {gxy}, mc {mc}, starts "
            f"{tuple(plan.starts.shape)}, w0 {tuple(plan.w0.shape)}, wcap "
            f"{tuple(plan.wcap.shape)}")
    return gxy * gxy, mc


def _tile_masks(comps, starts, w0, wcap, mc, noff, c0, c1, rpw, rolled,
                first_off=0, dmin=0):
    """bool[c1-c0, mc, noff-first_off, rpw, 64, 128]: the tile test of
    buckets (columns or slabs) [c0, c1) on offsets first_off .. noff-1.

    Entry [c, k, off, r, a, l] is set iff sorted sphere i = g0 + a of
    chunk k (g0 = starts[c] + 64k, i inside the bucket) strictly
    overlaps the sphere j at lane l of window row r of offset
    ``first_off + off`` (see the module docstring), j > i for offset 0,
    and j > i + dmin on every offset when ``dmin`` > 0. ``comps`` is the
    stream's six box channels, flattened to [6, Rp*128]; ``w0``/``wcap``
    are flat, (bucket * mc + k) * noff + off.
    """
    dev = comps.device
    npos = comps.shape[1]
    bc = c1 - c0
    g0 = starts[c0:c1, None].long() \
        + torch.arange(mc, device=dev) * CHUNK                  # [bc, mc]
    i = g0[..., None] + torch.arange(CHUNK, device=dev)          # [bc, mc, 64]
    a_ok = i < starts[c0 + 1:c1 + 1, None, None]
    sl = slice(c0 * mc * noff, c1 * mc * noff)
    w = w0[sl].view(bc, mc, noff, 1, 1)[:, :, first_off:].long()
    wc = wcap[sl].view(bc, mc, noff, 1, 1)[:, :, first_off:].long()
    rl = (torch.arange(rpw, device=dev)[:, None] * LANE
          + torch.arange(LANE, device=dev))                      # [rpw, 128]
    if rolled:
        j = w + rl                                   # [bc, mc, noff, rpw, 128]
        in_win = rl < wc
    else:
        j = (w // LANE) * LANE + rl
        in_win = (j >= w) & (j < w + wc)
    a = comps[:, i.clamp(max=npos - 1)][:, :, :, None, None, :, None]
    b = comps[:, j.clamp(max=npos - 1)][:, :, :, :, :, None, :]
    m = a_ok[:, :, None, None, :, None] & in_win[:, :, :, :, None, :]
    for lo_c, hi_c in ((0, 3), (1, 4), (2, 5)):
        m &= (a[hi_c] > b[lo_c]) & (a[lo_c] < b[hi_c])
    if dmin:
        m &= j[:, :, :, :, None, :] > i[:, :, None, None, :, None] + dmin
    if first_off == 0:
        m[:, :, 0] &= j[:, :, 0, :, None, :] > i[:, :, None, :, None]
    return m


def _tile_batches(stream, starts, w0, wcap, nbuckets, mc, noff, rpw,
                  rolled, first_off=0, dmin=0):
    """Yield the tile masks bucket batch by bucket batch (bounded
    memory)."""
    comps = stream[:, :6, :].permute(1, 0, 2).reshape(6, -1)
    w0, wcap = w0.reshape(-1), wcap.reshape(-1)
    step = max(1, (1 << 25) // (mc * noff * rpw * CHUNK * LANE))
    for c0 in range(0, nbuckets, step):
        yield _tile_masks(comps, starts, w0, wcap, mc, noff, c0,
                          min(nbuckets, c0 + step), rpw, rolled, first_off,
                          dmin)


def tile_count_plain(stream, starts, w0, wcap, nbuckets, mc, noff, rpw,
                     rolled, first_off=0, dmin=0):
    """Plain PyTorch count of set tile-test entries on offsets
    ``first_off`` .. noff-1 (j > i + ``dmin`` on each when dmin > 0),
    the slab and the column counts' shared reference: int64."""
    total = torch.zeros((), dtype=torch.int64, device=stream.device)
    for m in _tile_batches(stream, starts, w0, wcap, nbuckets, mc, noff,
                           rpw, rolled, first_off, dmin):
        total += m.sum()
    return total


def tile_words_plain(stream, starts, w0, wcap, nbuckets, mc, noff, rpw,
                     rolled):
    """Plain PyTorch packed tile masks, int32[nbuckets*NG,
    KG*noff*rpw*2, 128] holding uint32 words, (KG, NG) =
    ``mask_groups(mc, rpw)``: block c*NG + g, row ((kk*noff + off)*rpw
    + r)*2 + h for chunk k = g*KG + kk, bit b = a-row h*32 + b. The
    slab and the column masks' shared reference."""
    kg, ng = mask_groups(mc, rpw)
    dev = stream.device
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))[:, None]
    out = []
    for m in _tile_batches(stream, starts, w0, wcap, nbuckets, mc, noff,
                           rpw, rolled):
        bc = m.shape[0]
        # [bc, mc, off, r, h, bit, lane] -> words [bc, mc, off, r, h, lane]
        words = (m.view(bc, mc, noff, rpw, 2, 32, LANE).long()
                 * weights).sum(-2)
        words = torch.cat([words, words.new_zeros(
            (bc, ng * kg - mc, noff, rpw, 2, LANE))], dim=1)
        out.append(words.reshape(bc * ng, kg * noff * rpw * 2, LANE))
    words = torch.cat(out)
    # uint32 bit patterns stored as int32.
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def sweep_count_plain(plan, rpw=2, rolled=False):
    """Plain PyTorch version of :func:`sweep_count`."""
    ncols, mc = _tables(plan)
    return tile_count_plain(plan.stream, plan.starts, plan.w0, plan.wcap,
                            ncols, mc, NOFF, rpw, rolled)


def sweep_count(plan, rpw=2, rolled=False):
    """int64 number of set tile-test entries of a column plan: the
    exact pair count iff ``plan.ok`` and ``plan.rows_needed <= rpw``
    (aligned rows) or ``plan.rows_rolled <= rpw`` (``rolled=True``).
    The kernel runs only the tests that an exact union-box cull leaves
    and stores nothing but the total (``csrc/sweep.cu``); the count is
    the plain version's."""
    if not plan.stream.is_cuda:
        return sweep_count_plain(plan, rpw, rolled)
    ncols, mc = _tables(plan)
    total = torch.zeros((1,), dtype=torch.int64, device=plan.stream.device)
    _build.launch(
        "sweep_count_launch",
        _build.require(plan.stream, torch.float32, "stream"),
        _build.require(plan.starts, torch.int32, "starts"),
        _build.require(plan.w0, torch.int32, "w0"),
        _build.require(plan.wcap, torch.int32, "wcap"), ncols, mc,
        int(rpw), int(bool(rolled)), total.data_ptr())
    _build.LAUNCHES["sweep_count_rolled" if rolled
                    else "sweep_count_aligned"] += 1
    return total[0]


def sweep_count_guarded(plan, rpw=2, rolled=False):
    """(count, no_wrap): the exact int64 count, and False where it
    reaches ``INT32_GUARD``, which callers AND into ``ok``."""
    count = sweep_count(plan, rpw, rolled)
    return count, count < INT32_GUARD


def sweep_masks_plain(plan, rpw=2):
    """Plain PyTorch version of :func:`sweep_masks`."""
    ncols, mc = _tables(plan)
    return tile_words_plain(plan.stream, plan.starts, plan.w0, plan.wcap,
                            ncols, mc, NOFF, rpw, rolled=False)


def sweep_masks(plan, rpw=2):
    """Packed tile masks at aligned rows, int32[ncols*NG, KG*5*rpw*2,
    128] holding uint32 words.

    The layout of the JAX ``sweep_masks``, with (KG, NG) =
    ``mask_groups(mc, rpw)``: block c*NG + g, row ((kk*5 + off)*rpw + r)*2
    + h for chunk k = g*KG + kk, lane l = stream lane l of window row r,
    bit b = a-row h*32 + b. Every word is written; dead chunks are 0.
    Exact iff ``plan.ok`` and ``plan.rows_needed <= rpw``. The kernel
    skips the tests of a mask word that an exact union-box cull shows to
    be 0 (``csrc/sweep.cu``); the words are the plain version's.
    """
    if not plan.stream.is_cuda:
        return sweep_masks_plain(plan, rpw)
    ncols, mc = _tables(plan)
    kg, ng = mask_groups(mc, rpw)
    out = torch.empty((ncols * ng, kg * NOFF * rpw * 2, LANE),
                      dtype=torch.int32, device=plan.stream.device)
    _build.launch(
        "sweep_masks_launch",
        _build.require(plan.stream, torch.float32, "stream"),
        _build.require(plan.starts, torch.int32, "starts"),
        _build.require(plan.w0, torch.int32, "w0"),
        _build.require(plan.wcap, torch.int32, "wcap"), ncols, mc,
        int(rpw), kg, ng, out.data_ptr())
    _build.LAUNCHES["sweep_masks"] += 1
    return out


@tracing.spanned("ct.column.residual")
def column_residual_count(plan, j_cap=None, base=1):
    """(int64 count, ok) of the column-plan window lanes beyond the first
    ``base``*128: the 5-offset form of ``slabs.residual_count``, over the
    same residual jobs. ``ok`` is False when more than ``j_cap`` jobs
    (default ``slabs.RESIDUAL_JOBS``) were needed."""
    m, _, _, ok = _residual_mask_tables(
        plan.stream, plan.starts, plan.w0.reshape(-1), plan.wcap.reshape(-1),
        plan.mc, NOFF, RESIDUAL_JOBS if j_cap is None else j_cap, base)
    return m.sum(), ok


def default_column_j_cap(plan, base=1):
    """Residual-job capacity of a column dual count, from the plan's
    shapes: the slab default from two rows up; at one row, 1/16 of the
    window table in 256-job steps (windows of parked power-law scenes
    average ~110 lanes, so the tail past 128 lanes is fat)."""
    if base >= 2:
        return RESIDUAL_JOBS
    T = int(np.prod(plan.w0.shape))
    return max(RESIDUAL_JOBS, -(-T // (16 * 256)) * 256)


def sweep_count_dual(plan, j_cap=None, base=1):
    """(int64 count, ok) by dual dispatch over a column plan: the rolled
    count kernel at ``base`` rows with windows clamped to base*128 lanes,
    plus the residual jobs for the lanes past them. ``ok`` folds the
    plan's capacities, the residual-job bound (``j_cap``, default
    :func:`default_column_j_cap`) and the int32 guard; the count is exact
    iff it is True."""
    if j_cap is None:
        j_cap = default_column_j_cap(plan, base)
    sweep_plan = plan._replace(wcap=torch.clamp_max(plan.wcap, base * LANE))
    with tracing.span("ct.column.sweep"):
        cnt, no_wrap = sweep_count_guarded(sweep_plan, rpw=base, rolled=True)
    rcnt, r_ok = column_residual_count(plan, j_cap, base)
    return cnt + rcnt, plan.ok & r_ok & no_wrap
