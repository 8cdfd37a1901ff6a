"""The program's public entries, as a traffic file names them.

``make(traffic, n, device)`` returns a callable that runs one frame,
``frame(coords, radii) -> Answer``, the way a simulation calls the
broad phase once a frame:

- ``Collider.get_collisions``: one ``Collider(n, **collider)`` made in
  set-up; each frame ``get_collisions(coords, radii, capacity)``, or
  ``get_collisions(coords, radii, 0, collisions=None)`` when the
  capacity is 0 (the retry ladder included; no ``ok`` is returned);
- ``collide``: ``collide(coords, radii, capacity, **kwargs)``.

The program is imported here and nowhere else in the harness.
"""

from typing import NamedTuple, Optional

import torch


class Answer(NamedTuple):
    """What one frame returned: the count, the [capacity, 2] pair buffer
    (None when counting) and ``ok`` (None where the entry has none)."""

    count: torch.Tensor
    pairs: Optional[torch.Tensor]
    ok: Optional[torch.Tensor]


def make(traffic, n, device):
    capacity = int(traffic["capacity"])
    kwargs = traffic.get("kwargs", {})
    if traffic["entry"] == "Collider.get_collisions":
        from collision_tpu_torch import Collider

        collider = Collider(n, device=device, **traffic.get("collider", {}))
        if capacity == 0:
            def frame(coords, radii):
                return Answer(collider.get_collisions(
                    coords, radii, 0, collisions=None), None, None)
        else:
            def frame(coords, radii):
                count, pairs = collider.get_collisions(coords, radii,
                                                       capacity)
                return Answer(count, pairs, None)
        return frame
    if traffic["entry"] == "collide":
        from collision_tpu_torch import collide

        def frame(coords, radii):
            res = collide(coords, radii, capacity, **kwargs)
            return Answer(res.count, res.pairs, res.ok)
        return frame
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def launch_counter():
    """The program's kernel launch counter (name -> launches so far)."""
    from collision_tpu_torch.kernels import _build

    return _build.LAUNCHES
