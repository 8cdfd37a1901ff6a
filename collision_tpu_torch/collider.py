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

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .columns import CHUNK, _f32, default_column_config, plan_columns
from .fill import BIG_FILL_THRESHOLD, mask_fill, slab_mask_fill
from .hetero import default_nb, hetero_collide
from .kernels.slab_sweep import slab_count_dual
from .kernels.sweep import RPW_LADDER, sweep_count_guarded
from .ops import scene_bounds
from .slabs import NO_PAIR, default_slab_config, plan_slabs

#: Default rows per window of the column count and fill.
DEFAULT_RPW = 2

#: n at or above which "auto" prefers the slab engine for count-only
#: steps, and for fills; the column engine below. The JAX package's
#: crossovers, measured on a TPU and copied unchanged: the H100's own are
#: still to be measured.
SLAB_AUTO_THRESHOLD = 65536
SLAB_FILL_AUTO_THRESHOLD = 524288

#: Smallest n at which "auto" pays the radius-spread probe.
HETERO_AUTO_MIN = 16384

#: Smallest n at which the hetero engine runs its S-S pass through the
#: slab engine rather than the column engine, unless the caller pinned
#: column knobs.
HETERO_SLAB_MIN = 65536

#: Predicted mean z-window slack (lanes past the 64-lane chunk span)
#: above which the slab engine's one-row dual dispatch stops fitting.
SLAB_SLACK_MAX = 40.0

#: Minimum factor by which parking the default big set must shrink the
#: predicted test reach (2*r_mean + 2*r_max) for a scene to count as
#: heterogeneous.
HETERO_GAIN_MIN = 2.0

_PORTED = ("auto", "slab", "column", "hetero")
_UNPORTED = ("grid", "bvh")


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


def collide(coords, radii, capacity, method="auto", gxy=None,
            col_capacity=None, slab_rows=None, rpw=DEFAULT_RPW, gx=None,
            nb=None):
    """One broad-phase step on the device of ``coords``.

    Args:
      coords: float32 [n, 3] sphere centers (n >= 1).
      radii:  float32 [n] sphere radii, on the same device.
      capacity: pair-buffer capacity; 0 = count-only. At most
        ``fill.BIG_FILL_THRESHOLD``.
      method: "slab" (x-sorted two-offset slab sweep, slabs.py),
        "column" (z-sorted column sweep + mask fill, columns.py),
        "hetero" (the ``nb`` largest spheres parked out of the small
        pass, hetero.py: the S-S pass on the slab engine at n >=
        ``HETERO_SLAB_MIN`` unless column knobs are given, on the column
        engine otherwise; needs n > 64), or "auto": at n >=
        ``HETERO_AUTO_MIN`` it first probes the radius spread, one host
        sync per call, and sends a scene it finds heterogeneous to the
        hetero engine, with the S-S engine and its knobs sized from the
        probe's small-class stats (at n >= ``HETERO_SLAB_MIN`` with no
        column knob and no ``gx`` given); otherwise slab counts at n >=
        ``SLAB_AUTO_THRESHOLD``, slab fills at n >=
        ``SLAB_FILL_AUTO_THRESHOLD``, the column engine below.
      gxy, col_capacity, slab_rows, rpw: column-engine knobs; a None
        resolves from ``columns.default_column_config(n)``. An ``rpw``
        equal to ``DEFAULT_RPW`` may be replaced by ``auto``'s hetero
        route.
      gx: slab count of the slab engine; None derives it from n
        (``slabs.default_slab_config``).
      nb: big-set size of the hetero engine; None is
        ``hetero.default_nb(n)``.

    Returns:
      :class:`CollisionResult`.
    """
    if method in _UNPORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP.md, modules to "
            f"port); {', '.join(map(repr, _PORTED))} are")
    if method not in _PORTED:
        raise ValueError(f"Unknown method: {method}")
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
    # The hetero engine's S-S pass: the column engine when the caller
    # pinned column knobs or below the crossover, the slab engine above.
    col_pinned = (gxy is not None or col_capacity is not None
                  or slab_rows is not None)
    hetero_engine = ("column" if col_pinned or n < HETERO_SLAB_MIN
                     else "slab")
    if method == "auto":
        stats = _route_hetero_eager(coords, radii, nb)
        if stats is not None:
            method = "hetero"
            if not col_pinned and n >= HETERO_SLAB_MIN and gx is None:
                # Size the S-S pass for the parked small class; the
                # derivation also picks the S-S engine.
                knobs = _hetero_route_knobs(n, _effective_nb(n, nb), *stats)
                if knobs[0] == "slab":
                    gx = knobs[1]
                else:
                    hetero_engine = "column"
                    gxy, col_capacity, slab_rows, pred_rpw = knobs[1:]
                    if rpw == DEFAULT_RPW:
                        rpw = pred_rpw
        elif capacity == 0:
            method = "slab" if n >= SLAB_AUTO_THRESHOLD else "column"
        else:
            method = "slab" if n >= SLAB_FILL_AUTO_THRESHOLD else "column"
    lo_scene, hi_scene = scene_bounds(coords)
    if n == 1:
        pairs = torch.full((capacity, 2), NO_PAIR, dtype=torch.int64,
                           device=coords.device) if capacity else None
        zero = torch.zeros((), dtype=torch.int64, device=coords.device)
        ok = torch.ones((), dtype=torch.bool, device=coords.device)
        return CollisionResult(zero, pairs, lo_scene, hi_scene, ok)
    if method == "slab":
        s_gx, s_cap, s_rows = default_slab_config(n, gx=gx)
        return _slab_collide(coords, radii, capacity, s_gx, s_cap, s_rows,
                             lo_scene, hi_scene)
    if method == "hetero":
        if n <= CHUNK:
            raise NotImplementedError(
                "method='hetero' needs n > 64 spheres; the JAX package runs "
                "the run-expansion fill there, which is not ported yet "
                "(ROADMAP.md, modules item 10)")
        return _hetero_collide(coords, radii, capacity, nb, rpw, gxy,
                               col_capacity, slab_rows, hetero_engine, gx,
                               lo_scene, hi_scene)
    auto = default_column_config(n)
    return _column_collide(
        coords, radii, capacity, auto[0] if gxy is None else gxy,
        auto[1] if col_capacity is None else col_capacity,
        auto[2] if slab_rows is None else slab_rows, rpw, lo_scene,
        hi_scene)


def _column_collide(coords, radii, capacity, gxy, col_capacity, slab_rows,
                    rpw, lo_scene, hi_scene):
    """Column-engine frame: the rolled count sweep, or the aligned masks
    kernel plus the sparse emission."""
    if capacity == 0:
        plan = plan_columns(coords, radii, gxy, col_capacity, slab_rows)
        count, no_wrap = sweep_count_guarded(plan, rpw=rpw, rolled=True)
        ok = plan.ok & (plan.rows_rolled <= rpw) & no_wrap
        return CollisionResult(count, None, lo_scene, hi_scene, ok)
    ida, idb, total, ok = mask_fill(
        coords, radii, capacity, gxy, col_capacity, slab_rows, rpw=rpw)
    return CollisionResult(total, torch.stack([ida, idb], dim=1), lo_scene,
                           hi_scene, ok)


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


def _hetero_collide(coords, radii, capacity, nb, rpw, gxy, col_capacity,
                    slab_rows, engine, gx, lo_scene, hi_scene):
    """Hetero-engine frame (hetero.py): the S-S pass on ``engine``, slab
    (``gx``; the column knobs unused) or column."""
    if engine == "slab":
        pairs, total, ok = hetero_collide(coords, radii, capacity, nb=nb,
                                          engine="slab", gx=gx)
    else:
        pairs, total, ok = hetero_collide(
            coords, radii, capacity, nb=nb, gxy=gxy,
            col_capacity=col_capacity, slab_rows=slab_rows, rpw=rpw)
    return CollisionResult(total, pairs, lo_scene, hi_scene, ok)


def _quantize_gx(gx):
    """A derived slab count rounded up to a geometric bucket (~1.25x steps
    from 8, at most 4096), so the knobs derived from a moving scene's
    stats change rarely from frame to frame. A finer grid never changes a
    result."""
    gx = max(int(gx), 1)
    if gx <= 8:
        return gx
    step = max(int(math.ceil(math.log(gx / 8.0) / math.log(1.25))), 0)
    q = int(math.ceil(8 * 1.25 ** step))
    while q < gx:
        q = int(math.ceil(q * 1.25))
    return min(q, 4096)


def _hetero_stats(coords, radii, nb):
    """f32[7] = (r_max, r_small, r_mean_small, r_mean_all, ext_x, ext_y,
    ext_z): the radius spread after parking the ``nb`` largest, the
    small-class and whole-scene mean radii, and the scene extents, in
    one tensor so the caller pays one host sync."""
    n = radii.shape[0]
    top = torch.topk(radii, nb + 1).values
    lo, hi = scene_bounds(coords)
    rsum = radii.sum()
    mean_small = (rsum - top[:nb].sum()) / _f32(max(n - nb, 1), radii.device)
    mean_all = rsum / _f32(n, radii.device)
    return torch.cat(
        [torch.stack([top[0], top[nb], mean_small, mean_all]), hi - lo])


def _predicted_slab_slack(n, r_max, r_mean, ext):
    """Mean z-window slack (lanes) of the dual-dispatch slab engine on an
    n-sphere scene with the given radius stats; the engine fits when
    this stays under ``SLAB_SLACK_MAX``."""
    ext_x, _, ext_z = (max(float(e), 0.0) for e in ext)
    gx_f = default_slab_config(
        n, r_max=max(float(r_max), 1e-30), ext=ext_x)[0]
    z_lanes = n / max(ext_z, 1e-30)
    return (2.0 * float(r_mean) + 2.0 * float(r_max)) * z_lanes \
        / max(gx_f, 1)


def _hetero_route_knobs(n, nb, r_small, r_mean, ext):
    """S-S engine and knobs for a heterogeneous scene, from the probe's
    stats: ("slab", gx) when the predicted z-window slack of the
    (physically clamped) slab grid fits the dual dispatch, else
    ("column", gxy, col_capacity, slab_rows, rpw) with the column grid
    clamped at 2*r_small and the rows-per-window rung sized for the
    predicted window plus Poisson headroom. Host arithmetic only; ``nb``
    is unused, as in the JAX package."""
    ext_x, ext_y, ext_z = (max(float(e), 0.0) for e in ext)
    r_small = max(float(r_small), 1e-30)
    r_mean = max(float(r_mean), 0.0)
    reach = 2.0 * r_mean + 2.0 * r_small

    gx_f = default_slab_config(n, r_max=r_small, ext=ext_x)[0]
    z_lanes = n / max(ext_z, 1e-30)       # sorted lanes per unit z
    if reach * z_lanes / max(gx_f, 1) <= SLAB_SLACK_MAX:
        return "slab", _quantize_gx(gx_f)

    # Column cells at least 2*r_small wide (the 5-offset stencil's
    # invariant), occupancy-targeted otherwise.
    gxy_cap = int(min(ext_x, ext_y) / (2.0 * r_small)) if r_small else 64
    gxy = int(np.clip(round((n / 1500.0) ** 0.5), 1, 64))
    gxy = max(1, min(gxy, max(gxy_cap, 1)))
    _, col_cap, slab_rows = default_column_config(n, gxy=gxy)
    occ = n / float(gxy * gxy)
    slack_col = reach * occ / max(ext_z, 1e-30)
    win = 64.0 + slack_col + 6.0 * slack_col ** 0.5 + 16.0
    need = int(-(-win // 128)) + 1
    rpw = next((r for r in RPW_LADDER if r >= need), RPW_LADDER[-1])
    return "column", gxy, col_cap, slab_rows, rpw


def _effective_nb(n, nb):
    """The big-set size the hetero engine parks for an n-sphere scene and
    a requested ``nb`` (None: the default), so the probe measures the
    radii that really stay in the S-S pass."""
    if nb is None:
        return default_nb(n)
    eff = min(int(nb), (n // CHUNK) * CHUNK) or min(CHUNK, n)
    return min(max(eff, 1), n - 1)


def _route_hetero_eager(coords, radii, nb=None):
    """(r_small, r_mean_small, ext[3]) when "auto" should use the hetero
    engine, None otherwise.

    Below ``HETERO_AUTO_MIN`` spheres it decides nothing and costs
    nothing. At or above it, one probe reads the radius spread at the big
    set the engine would park (``_effective_nb(n, nb)``) and the scene
    extents, one host sync. The scene is heterogeneous when the slab
    engine's predicted windows exceed ``SLAB_SLACK_MAX`` and parking the
    big set shrinks the test reach by ``HETERO_GAIN_MIN``.
    """
    n = coords.shape[0]
    if n < HETERO_AUTO_MIN or n <= CHUNK:
        return None
    s = _hetero_stats(coords, radii, _effective_nb(n, nb)).cpu().tolist()
    r_max, r_small, r_mean_s, r_mean_all = s[:4]
    ext = s[4:7]
    if _predicted_slab_slack(n, r_max, r_mean_all, ext) <= SLAB_SLACK_MAX:
        return None
    gain = (r_mean_all + r_max) / max(r_mean_s + r_small, 1e-30)
    if gain < HETERO_GAIN_MIN:
        return None
    return r_small, r_mean_s, ext
