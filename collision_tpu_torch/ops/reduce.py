"""Scene-bounds reduction (collision_tpu/ops/reduce.py)."""

import torch


def scene_bounds(coords):
    """(min, max) over [n, 3] coords: the scene AABB of the centers."""
    return torch.amin(coords, dim=0), torch.amax(coords, dim=0)
