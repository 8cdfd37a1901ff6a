"""Hand-written CUDA kernels of the port's paths, each beside its plain
PyTorch version (sources in ``../csrc``, built by ``_build``). The public
names are the JAX package's (collision_tpu/kernels/__init__.py)."""

from .batched import batched_count
from .compact import compact_mask
from .emit import emit_pairs, grid_fill, halo_tile_counts
from .halo import halo_pairs
from .slab_sweep import (diag_count, slab_count, slab_count_diag,
                         slab_count_dual, slab_count_guarded,
                         slab_sweep_masks)
from .sweep import sweep_count, sweep_count_guarded, sweep_masks

__all__ = [
    "batched_count",
    "compact_mask",
    "emit_pairs",
    "grid_fill",
    "halo_tile_counts",
    "halo_pairs",
    "diag_count",
    "slab_count",
    "slab_count_diag",
    "slab_count_dual",
    "slab_count_guarded",
    "slab_sweep_masks",
    "sweep_count",
    "sweep_count_guarded",
    "sweep_masks",
]
