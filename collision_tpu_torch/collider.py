"""Public broad-phase API: ``collide`` (collision_tpu/collider.py).

Contracts kept from the JAX package (and its reference):
  1. the pairs are the unordered pairs of original sphere ids whose
     center +- radius boxes strictly overlap, each once, no self-pairs;
  2. the pair order is deterministic;
  3. the count is the true total even past ``capacity``, and only the
     first ``capacity`` pairs are written;
  4. capacity == 0 counts without a pair buffer;
  5. ``ok`` is False when a static knob was too small; the result is
     then not to be trusted, and the caller retries with larger knobs.
"""

from typing import NamedTuple, Optional

import torch

from .fill import BIG_FILL_THRESHOLD, slab_mask_fill
from .kernels.slab_sweep import slab_count_dual
from .ops import scene_bounds
from .slabs import NO_PAIR, default_slab_config, plan_slabs


class CollisionResult(NamedTuple):
    """Result of one broad-phase step.

    count:     int64 0-dim — true number of colliding pairs (may exceed
               capacity).
    pairs:     int64 [capacity, 2] of original sphere ids, or None when
               capacity == 0. Slots past min(count, capacity) hold
               0xFFFFFFFF.
    scene_min: float32 [3] scene AABB lower corner (of centers).
    scene_max: float32 [3] scene AABB upper corner.
    ok:        bool 0-dim — True unless a static knob was insufficient.

    The JAX package returns count and pairs as uint32. Here int64 carries
    the same values, because torch's uint32 lacks ``searchsorted`` and
    ``<<``, which the plan and the emission need.
    """

    count: torch.Tensor
    pairs: Optional[torch.Tensor]
    scene_min: torch.Tensor
    scene_max: torch.Tensor
    ok: torch.Tensor

    @property
    def overflowed(self):
        """True when count exceeded the pair-buffer capacity."""
        if self.pairs is None:
            return False
        return bool(self.count > self.pairs.shape[0])


def collide(coords, radii, capacity, method="slab", gx=None):
    """One broad-phase step on the device of ``coords``.

    Args:
      coords: float32 [n, 3] sphere centers (n >= 1).
      radii:  float32 [n] sphere radii, on the same device.
      capacity: pair-buffer capacity; 0 = count-only. At most
        ``fill.BIG_FILL_THRESHOLD``.
      method: "slab", the only engine ported so far.
      gx: slab count of the slab engine; None derives it from n
        (``slabs.default_slab_config``).

    Returns:
      :class:`CollisionResult`.
    """
    if method != "slab":
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP.md, modules to "
            "port); only 'slab' is")
    if coords.dtype != torch.float32 or radii.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 is ported; the float64 engines (BVH, run-expansion "
            "fill) are queued in ROADMAP.md, modules items 10-11")
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    if capacity > BIG_FILL_THRESHOLD:
        raise NotImplementedError(
            f"capacity {capacity} > BIG_FILL_THRESHOLD ({BIG_FILL_THRESHOLD}): "
            "large-capacity emission is not ported yet (ROADMAP.md, modules "
            "item 8)")
    n = coords.shape[0]
    lo_scene, hi_scene = scene_bounds(coords)
    if n == 1:
        pairs = torch.full((capacity, 2), NO_PAIR, dtype=torch.int64,
                           device=coords.device) if capacity else None
        zero = torch.zeros((), dtype=torch.int64, device=coords.device)
        ok = torch.ones((), dtype=torch.bool, device=coords.device)
        return CollisionResult(zero, pairs, lo_scene, hi_scene, ok)
    s_gx, s_cap, s_rows = default_slab_config(n, gx=gx)
    return _slab_collide(coords, radii, capacity, s_gx, s_cap, s_rows,
                         lo_scene, hi_scene)


def _slab_collide(coords, radii, capacity, gx, col_capacity, slab_rows,
                  lo_scene, hi_scene):
    """Slab-engine frame: the dual-dispatch count (one-row sweep kernel +
    residual jobs) or the dual-dispatch fill (one-row masks kernel +
    residual pairs + sparse emission)."""
    if capacity == 0:
        plan = plan_slabs(coords, radii, gx, col_capacity, slab_rows)
        count, d_ok = slab_count_dual(plan)
        return CollisionResult(count, None, lo_scene, hi_scene,
                               plan.ok & d_ok)
    ida, idb, total, ok = slab_mask_fill(
        coords, radii, capacity, gx, col_capacity, slab_rows)
    return CollisionResult(total, torch.stack([ida, idb], dim=1), lo_scene,
                           hi_scene, ok)
