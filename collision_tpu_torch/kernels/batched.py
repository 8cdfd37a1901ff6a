"""The grid engine's count at an even ``grid_dim``.

Port of collision_tpu/kernels/batched.py. The TPU kernel sweeps two
y-columns per grid step, to halve its per-step DMA issue and share their
3x4 neighbourhood. The card has no per-step DMA issue to save: this
wrapper launches the grid count kernel of ``csrc/grid.cu`` that
``halo.halo_pairs`` counts with, one center cell per block, which culls
each neighbour tile's rows against the two cells' union boxes. (A
variant of the unculled count with two y-adjacent centers per block,
loading their joint neighbourhood once, measured 15-22% slower on an
H100.) On a CPU tensor the plain version runs.
"""

import torch

from ..grid import tile_counts_plain
from . import _build, emit


def _check_even(grid_dim):
    if grid_dim % 2:
        raise ValueError(
            f"grid_dim must be even for y-batching, got {grid_dim}")


def batched_count_plain(bins, grid_dim, cell_capacity):
    """Plain PyTorch version of :func:`batched_count`."""
    _check_even(grid_dim)
    return tile_counts_plain(bins, grid_dim, cell_capacity) \
        .sum(dtype=torch.int64)


def batched_count(bins, grid_dim, cell_capacity):
    """Total pair count (int64) from padded bins; ``grid_dim`` even."""
    _check_even(grid_dim)
    if not bins.is_cuda:
        return batched_count_plain(bins, grid_dim, cell_capacity)
    total = emit.count_launch(bins, grid_dim, cell_capacity, per_tile=False)
    _build.LAUNCHES["batched_count"] += 1
    return total
