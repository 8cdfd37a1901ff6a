"""PyTorch + CUDA port of collision_tpu's slab, column and hetero engines.

The port keeps the JAX package's names and contracts: ``collide`` returns
the exact set of strictly-overlapping sphere-AABB pairs of original ids,
the true count even past ``capacity``, and ``ok=False`` when a static
knob was too small. It runs on the device of the tensors it is given:
on a CUDA tensor every kernel of the path is a hand-written sm_90a kernel
(``csrc/``, built on first use); on a CPU tensor each kernel's plain
PyTorch version runs instead.

Ported: ``method="slab"``, ``"column"``, ``"hetero"`` (mixed radii: the
largest spheres parked out of the small pass) and ``"auto"`` (the
default: the hetero engine on scenes its radius probe finds
heterogeneous, else slab or column by n), for float32 count-only steps
and for fills up to ``fill.BIG_FILL_THRESHOLD`` pairs.
"""

from .collider import CollisionResult, collide

__all__ = ["CollisionResult", "collide"]
