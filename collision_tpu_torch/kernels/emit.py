"""The grid engine's split fill: tile counts, scan, hit tiles, emission.

Port of collision_tpu/kernels/emit.py. A tile is one (cell, offset) pair
of the grid stencil: cell column ``col = x*gd + y``, cell ``z``, offset
``o`` (0 the self tile, then ``grid._HALF_OFFSETS``), flat id
``col*tile_pad + z*14 + o`` with ``tile_pad = round_up(14*gd, 128)``.

1. :func:`halo_tile_counts`: the pairs of every tile, int32[gd^2,
   tile_pad] (pad tiles 0).
2. An int64 exclusive scan of the flat counts gives each tile the first
   slot of its pairs; the sum is the true total.
3. ``compact_mask`` (kernel 3) lists the hit tiles in ascending order.
   Each holds at least one pair, so tiles past the first ``capacity``
   can only hold pairs past ``capacity``.
4. :func:`emit_pairs`: each hit tile's pairs at its base, (i, j)
   row-major, i over the center cell's slots, j over the neighbour's.

On a CUDA tensor the wrappers launch the kernels of ``csrc/grid.cu``; on
a CPU tensor they run the plain PyTorch versions beside them. The TPU's
batches of 8 tiles per grid step (``_BATCH``) and the lane-oriented twin
of the bins are not ported: a warp takes one tile and reads the rows as
they lie. Pairs are uint32 ids held in int64 [capacity, 2]; unused slots
hold 0xFFFFFFFF.
"""

import torch

from .. import tracing
from ..grid import TILE_OFFSETS, _tile_overlap, id_bits, tile_counts_plain
from ..slabs import NO_PAIR
from ..utils import round_up
from . import _build, compact

#: Tiles per batch of the plain emission (bounded [batch, M, M] masks).
_EMIT_TILES = 1024


def tile_pad(grid_dim):
    """Tile slots per cell column: 14 per cell, rounded up to 128."""
    return round_up(14 * grid_dim, 128)


def _bins_ptr(bins, grid_dim, cell_capacity):
    gp = grid_dim + 2
    if tuple(bins.shape) != (gp, gp, gp, cell_capacity, 8):
        raise ValueError(
            f"bins must be [{gp}, {gp}, {gp}, {cell_capacity}, 8], got "
            f"{tuple(bins.shape)}")
    return _build.require(bins, torch.float32, "bins")


def count_launch(bins, grid_dim, cell_capacity, per_tile):
    """Launch the grid count kernel: int32[gd^2, tile_pad] tile counts
    when ``per_tile``, else the int64 total. Counts no launch: the callers
    do."""
    p = _bins_ptr(bins, grid_dim, cell_capacity)
    dev = bins.device
    if per_tile:
        tc = torch.zeros((grid_dim * grid_dim, tile_pad(grid_dim)),
                         dtype=torch.int32, device=dev)
        _build.launch("grid_count_launch", p, grid_dim, cell_capacity,
                      tc.data_ptr(), tc.shape[1], None)
        return tc
    total = torch.zeros((1,), dtype=torch.int64, device=dev)
    _build.launch("grid_count_launch", p, grid_dim, cell_capacity, None, 0,
                  total.data_ptr())
    return total[0]


def halo_tile_counts_plain(bins, grid_dim, cell_capacity):
    """Plain PyTorch version of :func:`halo_tile_counts`."""
    gd = grid_dim
    tc = tile_counts_plain(bins, gd, cell_capacity)      # [14, gd^3]
    out = torch.zeros((gd * gd, tile_pad(gd)), dtype=torch.int32,
                      device=bins.device)
    out[:, :14 * gd] = tc.reshape(14, gd * gd, gd).permute(1, 2, 0) \
        .reshape(gd * gd, 14 * gd)
    return out


def halo_tile_counts(bins, grid_dim, cell_capacity):
    """Per-tile pair counts: int32[grid_dim^2, tile_pad] (tile = z*14 + o,
    padded to a multiple of 128; pad tiles count 0)."""
    if not bins.is_cuda:
        return halo_tile_counts_plain(bins, grid_dim, cell_capacity)
    tc = count_launch(bins, grid_dim, cell_capacity, per_tile=True)
    _build.LAUNCHES["grid_tile_counts"] += 1
    return tc


def emit_pairs_plain(bins, tiles, bases, grid_dim, cell_capacity, capacity,
                     *, n_hit=None):
    """Plain PyTorch version of :func:`emit_pairs`."""
    dev = bins.device
    gd, M = grid_dim, cell_capacity
    pad = tile_pad(gd)
    pairs = torch.full((capacity, 2), NO_PAIR, dtype=torch.int64, device=dev)
    keep = bases < capacity
    if n_hit is not None:
        keep &= torch.arange(bases.numel(), device=dev) < n_hit
    tiles, bases = tiles[keep].long(), bases[keep].long()
    off = torch.tensor(TILE_OFFSETS, device=dev)
    tri = torch.ones((M, M), dtype=torch.bool, device=dev).triu(1)
    for e0 in range(0, tiles.numel(), _EMIT_TILES):
        t = tiles[e0:e0 + _EMIT_TILES]
        col, zo = t // pad, t % pad
        z, o = zo // 14 + 1, zo % 14
        x, y = col // gd + 1, col % gd + 1
        d = off[o]
        a = bins[x, y, z]                                    # [h, M, 8]
        b = bins[x + d[:, 0], y + d[:, 1], z + d[:, 2]]
        mask = _tile_overlap(a, b) & (tri | (o != 0)[:, None, None])
        # Hits in (tile, i, j) order: row-major within each tile.
        k, i, j = torch.nonzero(mask, as_tuple=True)
        cnt = mask.sum((1, 2))
        first = torch.cumsum(cnt, 0) - cnt
        slot = bases[e0:e0 + _EMIT_TILES][k] \
            + torch.arange(k.numel(), device=dev) - first[k]
        w = slot < capacity
        pairs[slot[w]] = torch.stack(
            [id_bits(a[k[w], i[w], 3]), id_bits(b[k[w], j[w], 3])], dim=1)
    return pairs


def emit_pairs(bins, tiles, bases, grid_dim, cell_capacity, capacity, *,
               n_hit=None):
    """Write each hit tile's pairs at its prescanned base offset.

    Args:
      tiles: int[h] flat hit-tile ids (col*tile_pad + z*14 + o).
      bases: int[h] first pair slot of each tile; an entry with a base at
        or past ``capacity`` is skipped.
      n_hit: internal, :func:`grid_fill`'s: an int64 scalar tensor on the
        bins' device, the number of leading entries that are the hit tiles
        in ascending order with bases scanned from every tile's count (the
        entries from it on are skipped). The kernel then stops each tile at
        the next entry's base, and sizes nothing on the host. The buffer
        is the same as without it.

    Returns int64[capacity, 2] uint32 ids; untouched slots hold
    0xFFFFFFFF. Slots are int64: no limit at 2^31.
    """
    if not bins.is_cuda:
        return emit_pairs_plain(bins, tiles, bases, grid_dim, cell_capacity,
                                capacity, n_hit=n_hit)
    p = _bins_ptr(bins, grid_dim, cell_capacity)
    pairs = torch.full((capacity, 2), -1, dtype=torch.int32,
                       device=bins.device)
    tiles, bases = tiles.long().contiguous(), bases.long().contiguous()
    if tiles.shape != bases.shape:
        raise ValueError("tiles and bases must have one shape")
    hit_ptr = None
    if n_hit is not None:
        hit_ptr = _build.require(n_hit.reshape(()), torch.int64, "n_hit")
    if bases.numel() and capacity:
        _build.launch("grid_emit_launch", p, grid_dim, cell_capacity,
                      tile_pad(grid_dim), tiles.data_ptr(),
                      bases.data_ptr(), bases.numel(), hit_ptr, capacity,
                      pairs.data_ptr())
        _build.LAUNCHES["grid_emit"] += 1
    return pairs.view(torch.uint32).long()


def fill_entries(flat, capacity):
    """The emission's entries in :func:`grid_fill`: (tiles, bases, n_hit)
    from the flat tile counts ``flat``, every entry of the compacted hit
    list (min(capacity, tiles) of them, at least one; NO_INDEX tails as
    tile 0 at base ``capacity``) and the hit count, on the device."""
    bases = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    hit_idx, n_hit = compact.compact_mask(
        flat > 0, max(min(capacity, flat.numel()), 1))
    valid = hit_idx != compact.NO_INDEX
    tiles = torch.where(valid, hit_idx, 0)
    return tiles, torch.where(valid, bases[tiles], capacity), n_hit


def grid_fill(bins, grid_dim, cell_capacity, capacity):
    """Count + emit from bins: (pairs int64[capacity, 2], total int64).

    Pair slots come from an exclusive scan of the exact per-tile counts in
    ascending tile order: deterministic, gap-free, the first ``capacity``
    pairs written and the true total returned (the reference's overflow
    contract, collision.cl:203-207). No host sync: the emission reads the
    hit count on the device.
    """
    with tracing.span("ct.grid.counts"):
        flat = halo_tile_counts(bins, grid_dim, cell_capacity).reshape(-1)
        total = flat.sum(dtype=torch.int64)
        tiles, bases, n_hit = fill_entries(flat, capacity)
    with tracing.span("ct.grid.emit"):
        pairs = emit_pairs(bins, tiles, bases, grid_dim, cell_capacity,
                           capacity, n_hit=n_hit)
    return pairs, total
