"""PyTorch + CUDA port of collision_tpu's slab, column, hetero and grid
engines.

The port keeps the JAX package's names and contracts: ``collide`` returns
the exact set of strictly-overlapping sphere-AABB pairs of original ids,
the true count even past ``capacity``, and ``ok=False`` when a static
knob was too small. It runs on the device of the tensors it is given:
on a CUDA tensor every kernel of the path is a hand-written sm_90a kernel
(``csrc/``, built on first use); on a CPU tensor each kernel's plain
PyTorch version runs instead.

Ported: ``method="slab"``, ``"column"``, ``"hetero"`` (mixed radii: the
largest spheres parked out of the small pass), ``"grid"`` (the dense
uniform-grid stencil, with ``build_grid`` and ``grid_count``) and
``"auto"`` (the
default: the hetero engine on scenes its radius probe finds
heterogeneous, else slab or column by n), for count-only steps and
fills at any capacity; and the reference's ``Collider`` API
(``get_collisions``) and ``collide_exact``, which retry a step whose
``ok`` is False with exact knobs. ``Collider`` runs on the card unless
it is given ``device="cpu"``. Float32 steps run the kernels; float64
steps run the run-expansion fill (``fill.run_fill``) at input precision.
"""

from .collider import Collider, CollisionResult, collide, collide_exact
from .grid import GridCounts, build_grid, grid_count

__all__ = ["Collider", "CollisionResult", "GridCounts", "build_grid",
           "collide", "collide_exact", "grid_count"]
