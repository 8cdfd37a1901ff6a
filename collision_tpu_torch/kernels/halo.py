"""The grid engine's halo sweep: count, and count + emission.

Port of collision_tpu/kernels/halo.py. From the padded bins of
``grid.build_grid`` it counts the colliding pairs of every tile (each
cell against itself, upper triangle, and its 13 lexicographically
positive neighbours) and, with ``capacity > 0``, writes the first
``capacity`` pairs in the JAX kernel's order: tiles ascending by (x*gd +
y, z, o), (i, j) row-major within a tile.

The TPU kernel counts and emits in one sequential sweep through a cursor
in SMEM, and keeps the pair buffer in VMEM (so capacity stays below
~400k there). Blocks of the card run in no order and have no such
cursor: on a CUDA tensor the count is one launch of the grid count
kernel (``csrc/grid.cu``: one warp per center cell, which tests a
neighbour's rows only where they meet the center's union box and the
center's only where they meet the neighbour's, an exact cull), and the
emission is ``emit.grid_fill`` (tile counts, an int64 scan for each
tile's first slot, the hit tiles, the tile emission), which writes the
same buffer at any capacity. On a CPU tensor the plain version runs.
"""

import torch

from ..grid import tile_counts_plain
from . import _build, emit


def halo_pairs_plain(bins, grid_dim, cell_capacity, capacity):
    """Plain PyTorch version of :func:`halo_pairs`: ``grid_fill``'s steps
    through their plain versions."""
    if capacity == 0:
        return None, tile_counts_plain(bins, grid_dim, cell_capacity) \
            .sum(dtype=torch.int64)
    flat = emit.halo_tile_counts_plain(bins, grid_dim, cell_capacity) \
        .reshape(-1)
    bases = torch.cumsum(flat, 0, dtype=torch.int64) - flat
    tiles = torch.nonzero(flat).flatten()
    return emit.emit_pairs_plain(bins, tiles, bases[tiles], grid_dim,
                                 cell_capacity, capacity), \
        flat.sum(dtype=torch.int64)


def halo_pairs(bins, grid_dim, cell_capacity, capacity):
    """Count (and emit, if capacity > 0) colliding pairs from padded bins.

    Args:
      bins: [grid_dim+2]^3 x [cell_capacity, 8] float32 padded bins from
        ``grid.build_grid``.
      capacity: 0 = count-only; else the pair-buffer capacity.

    Returns:
      (pairs int64[capacity, 2] of uint32 ids, unused slots 0xFFFFFFFF,
      or None; total int64): the total is the true pair count even when
      it exceeds capacity.
    """
    if not bins.is_cuda:
        return halo_pairs_plain(bins, grid_dim, cell_capacity, capacity)
    if capacity:
        return emit.grid_fill(bins, grid_dim, cell_capacity, capacity)
    total = emit.count_launch(bins, grid_dim, cell_capacity, per_tile=False)
    _build.LAUNCHES["halo_count"] += 1
    return None, total
