"""Two-level radius bucketing (collision_tpu/hetero.py).

Only the big-set size is ported: the eager ``auto`` probe
(``collider._route_hetero_eager``) measures the radius spread at the
big set the hetero engine would park. The engine itself is queued in
ROADMAP.md (modules, item 9).
"""

from .columns import CHUNK

#: Big-set size cap: the spheres parked out of the small-small pass.
DEFAULT_NB = 1024


def default_nb(n):
    """Big-set size for an n-sphere scene (always < n, chunk-aligned)."""
    nb = min(DEFAULT_NB, max(CHUNK, n // 8))
    return max(CHUNK, (nb // CHUNK) * CHUNK) if n > CHUNK else CHUNK
