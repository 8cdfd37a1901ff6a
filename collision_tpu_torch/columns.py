"""Stream geometry shared by the slab engine (collision_tpu/columns.py).

Only the constants and the z quantizer are ported: the column engine
itself is still queued in ROADMAP.md.
"""

import torch

#: Spheres per a-chunk (one chunk = one banded tile row group).
CHUNK = 64

#: Sphere rows per stream row (lanes).
LANE = 128


def _quantize(z, lo, scale, zmax):
    """Monotone float32 -> integer quantization, as int64.

    ``(z - lo) * scale`` is computed in float32, clamped at 0, truncated
    to an integer, and clamped at ``zmax`` in the integer domain: float32
    rounds ``zmax = 2^k - 1`` up, which would let a max-z sphere spill
    into the slab bits of the packed sort key.
    """
    q = torch.clamp_min((z - lo) * scale, 0.0)
    return torch.clamp_max(q.to(torch.int64), zmax)
