"""The grid engine's bins on the card: bounds and cell size, cell keys, a
stable sort on the key's bits and one pass that writes every bin slot.

Replaces no TPU kernel: the JAX package builds the bins with XLA ops
(collision_tpu/grid.py: build_grid). On a CUDA tensor the wrapper
enqueues the chain of ``csrc/grid_bins.cu`` on the current stream (one
entry point, five kernels and cub's radix sort, no host sync; its bounds,
packing, sort and bucket starts are ``csrc/bucket_sort.cuh``'s, shared
with the slab plan); on a CPU tensor it runs ``grid.build_grid_plain``,
the same bins bit for bit.
"""

import torch

from ..grid import build_grid_plain as build_bins_plain
from . import _build

__all__ = ["build_bins", "build_bins_plain"]


def build_bins(coords, radii, grid_dim, cell_capacity):
    """(bins, ok, ids_sorted) as ``grid.build_grid`` returns them."""
    if not coords.is_cuda:
        return build_bins_plain(coords, radii, grid_dim, cell_capacity)
    dt = coords.dtype
    if dt not in (torch.float32, torch.float64) or radii.dtype != dt:
        raise ValueError(f"coords and radii must share a float32 or float64 "
                         f"type, got {dt} and {radii.dtype}")
    coords, radii, n = _build.spheres(coords, radii)
    if n >= 2 ** 31:
        raise ValueError("build_grid takes fewer than 2^31 spheres")
    gp = grid_dim + 2
    dev = coords.device
    bins = torch.empty((gp, gp, gp, cell_capacity, 8), dtype=dt, device=dev)
    ids = torch.empty((n,), dtype=torch.int64, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    f64 = int(dt == torch.float64)
    work = torch.empty(
        (_build.workspace_bytes("grid_bins_workspace", n, grid_dim, f64),),
        dtype=torch.uint8, device=dev)
    _build.launch("grid_bins_launch", coords.data_ptr(), radii.data_ptr(), n,
                  grid_dim, cell_capacity, f64,
                  work.data_ptr(), work.numel(), bins.data_ptr(),
                  ids.data_ptr(), ok.data_ptr())
    _build.LAUNCHES["grid_bins"] += 1
    return bins, ok, ids
