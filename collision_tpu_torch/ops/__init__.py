"""Plain tensor primitives of the slab plan (collision_tpu/ops)."""

from .offset import sorted_bucket_starts
from .reduce import scene_bounds
from .scan import inclusive_scan

__all__ = ["inclusive_scan", "scene_bounds", "sorted_bucket_starts"]
