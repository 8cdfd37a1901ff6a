"""Public broad-phase API: the functional ``collide`` step, and the
reference's ``Collider`` with ``collide_exact``, which retry with exact
knobs (collision_tpu/collider.py).

Contracts kept from the JAX package (and its reference):
  1. the pairs are the unordered pairs of original sphere ids whose
     center +- radius boxes strictly overlap, each once, no self-pairs;
  2. the pair order is deterministic;
  3. the count is the true total even past ``capacity``, and only the
     first ``capacity`` pairs are written;
  4. capacity == 0 counts without a pair buffer; ``Collider`` raises
     ValueError when pairs are asked for with no buffer;
  5. ``ok`` is False when a static knob was too small; the result is
     then not to be trusted, and the caller retries with larger knobs
     (``Collider`` and ``collide_exact`` do so from the plans' stats).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import tracing
from .columns import CHUNK, _scalar, default_column_config, plan_columns
from .fill import candidate_count, column_fill_pairs, run_fill, slab_fill_pairs
from .grid import build_grid, tile_counts_plain
from .hetero import _big_indices, default_nb, hetero_collide
from .kernels import batched, emit, halo
from .kernels.slab_sweep import slab_count_dual
from .kernels.sweep import RPW_LADDER, sweep_count_guarded
from .ops import scene_bounds
from .slabs import NO_PAIR, default_slab_config, plan_slabs
from .utils import round_up

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

#: Largest rows-per-window rung the retry ladders climb to before they
#: prefer a finer grid (gxy x2): cells clamp at 2*r_max, so a finer gxy
#: never changes a result, and it narrows the windows.
RPW_RETRY_MAX = 48

#: The BVH traversal's default stack depth (the reference's 64): the
#: JAX package's ``lbvh.traverse.STACK_DEPTH``, copied.
STACK_DEPTH = 64

_PORTED = ("auto", "slab", "column", "hetero", "grid")
_UNPORTED = ("bvh",)
_KERNEL_MODES = (None, "native", "interpret")


class CollisionResult(NamedTuple):
    """Result of one broad-phase step.

    count:     int64 0-dim — true number of colliding pairs (may exceed
               capacity).
    pairs:     int64 [capacity, 2] of original sphere ids, or None when
               capacity == 0. Slots past min(count, capacity) hold
               0xFFFFFFFF.
    scene_min: [3] scene AABB lower corner (of centers), in the input's
               float type.
    scene_max: [3] scene AABB upper corner.
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
        tracing.host_sync("collider.overflowed")
        return bool(self.count > self.pairs.shape[0])


def default_grid_config(n, target_occupancy=72):
    """(grid_dim, cell_capacity) for ~``target_occupancy`` spheres per cell,
    the JAX package's sizing copied unchanged (tuned there on a TPU; the
    H100's own optimum is not measured). Capacity is sized ~5 Poisson
    sigmas above the mean occupancy so uniform scenes don't trip the
    overflow retry.
    """
    gd = int(min(max(round((n / target_occupancy) ** (1 / 3)), 4), 64))
    occ = n / gd ** 3
    mc = int(round_up(int(occ + 5 * occ ** 0.5 + 4), 8))
    mc = max(16, min(mc, max(16, round_up(n, 8))))
    return gd, mc


def default_grid_dim(n, target_occupancy=72):
    """Cells per axis for ~``target_occupancy`` spheres per cell."""
    return default_grid_config(n, target_occupancy)[0]


def default_cand_capacity(n, capacity):
    """Bound on the run-expansion fill's conservative candidates (the JAX
    package's sizing: ~30 candidates a sphere on uniform scenes at the
    default column occupancy); the ``ok`` contract covers denser scenes."""
    return max(1 << 17, 8 * capacity, 32 * n)


@tracing.spanned("ct.collide")
def collide(coords, radii, capacity, stack_depth=STACK_DEPTH, method="auto",
            grid_dim=None, cell_capacity=None, gxy=None, col_capacity=None,
            slab_rows=None, rpw=DEFAULT_RPW, cand_capacity=None, gx=None,
            nb=None, kernel_mode=None):
    """One broad-phase step on the device of ``coords``.

    Float32 steps run the engines' kernels. Float64 steps, and
    ``method="hetero"`` at n <= 64 in either type, run the run-expansion
    fill (``fill.run_fill``) at input precision, as the JAX package does:
    its ``gxy`` is the column engine's knob, ``default_column_config(n)``
    for the slab and hetero methods. A float64 grid count is the plain
    stencil; a float64 grid fill reroutes to the column method.

    Args:
      coords: float32 or float64 [n, 3] sphere centers (n >= 1).
      radii:  [n] sphere radii, of the same type and on the same device.
      capacity: pair-buffer capacity; 0 = count-only. Fills above
        ``fill.BIG_FILL_THRESHOLD`` emit through the pair-emission
        kernel.
      stack_depth: the BVH traversal's stack depth; it has a use only
        with ``method="bvh"``, which is not ported yet.
      method: "slab" (x-sorted two-offset slab sweep, slabs.py),
        "column" (z-sorted column sweep + mask fill, columns.py),
        "hetero" (the ``nb`` largest spheres parked out of the small
        pass, hetero.py: the S-S pass on the slab engine at n >=
        ``HETERO_SLAB_MIN`` unless column knobs are given, on the column
        engine otherwise; the run-expansion fill at n <= 64), "grid"
        (the dense uniform-grid stencil, grid.py; never chosen by
        "auto"), or "auto": at n >=
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
      grid_dim, cell_capacity: grid-engine knobs (cells per axis, slots
        per cell); a None resolves from ``default_grid_config(n)``.
      cand_capacity: candidate bound of the run-expansion fill; None is
        :func:`default_cand_capacity`.
      kernel_mode: None, "native" or "interpret", accepted for the JAX
        package's signature and changing nothing: the tensors' device
        picks the kernels (CUDA) or their plain versions (CPU), so the
        port has no interpret mode and no ``interpret_kernels``.

    The parameters are the JAX package's, in its order and with its
    defaults.

    Returns:
      :class:`CollisionResult`.
    """
    if method in _UNPORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP.md, modules to "
            f"port); {', '.join(map(repr, _PORTED))} are")
    if method not in _PORTED:
        raise ValueError(f"Unknown method: {method}")
    if kernel_mode not in _KERNEL_MODES:
        raise ValueError(f"kernel_mode {kernel_mode!r} not in {_KERNEL_MODES}")
    if (coords.dtype not in (torch.float32, torch.float64)
            or radii.dtype != coords.dtype):
        raise ValueError(
            f"coords and radii must both be float32 or both float64, got "
            f"{coords.dtype} and {radii.dtype}")
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    n = coords.shape[0]
    f64 = coords.dtype == torch.float64
    if cand_capacity is None:
        cand_capacity = default_cand_capacity(n, capacity)
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
    if method == "grid" and capacity > 0 and f64:
        # The grid emission reads ids back out of float32 bins; the
        # column method enumerates at input precision.
        method = "column"
    lo_scene, hi_scene = scene_bounds(coords)
    if n == 1:
        pairs = torch.full((capacity, 2), NO_PAIR, dtype=torch.int64,
                           device=coords.device) if capacity else None
        zero = torch.zeros((), dtype=torch.int64, device=coords.device)
        ok = torch.ones((), dtype=torch.bool, device=coords.device)
        return CollisionResult(zero, pairs, lo_scene, hi_scene, ok)
    if method == "grid":
        tracing.ATTEMPTS["grid"] += 1
        auto_gd, auto_mc = default_grid_config(n)
        return _grid_collide(
            coords, radii, capacity, auto_gd if grid_dim is None else grid_dim,
            auto_mc if cell_capacity is None else cell_capacity, lo_scene,
            hi_scene)
    auto = default_column_config(n)
    if f64 or (method == "hetero" and n <= CHUNK):
        # The run-expansion fill: column-keyed, at the column knob where
        # the column method was asked for, else at the default grid.
        tracing.ATTEMPTS["runfill"] += 1
        pairs, total, ok = run_fill(
            coords, radii, capacity,
            gxy if method == "column" and gxy is not None else auto[0],
            cand_capacity)
        return CollisionResult(total, pairs, lo_scene, hi_scene, ok)
    if method == "slab":
        tracing.ATTEMPTS["slab"] += 1
        s_gx, s_cap, s_rows = default_slab_config(n, gx=gx)
        return _slab_collide(coords, radii, capacity, s_gx, s_cap, s_rows,
                             lo_scene, hi_scene)
    if method == "hetero":
        return _hetero_collide(coords, radii, capacity, nb, rpw, gxy,
                               col_capacity, slab_rows, hetero_engine, gx,
                               lo_scene, hi_scene)
    tracing.ATTEMPTS["column"] += 1
    return _column_collide(
        coords, radii, capacity, auto[0] if gxy is None else gxy,
        auto[1] if col_capacity is None else col_capacity,
        auto[2] if slab_rows is None else slab_rows, rpw, lo_scene,
        hi_scene)


def _column_collide(coords, radii, capacity, gxy, col_capacity, slab_rows,
                    rpw, lo_scene, hi_scene):
    """Column-engine frame: the rolled count sweep, or the aligned masks
    kernel plus the emission, which writes the result's pair buffer."""
    plan = plan_columns(coords, radii, gxy, col_capacity, slab_rows)
    if capacity == 0:
        with tracing.span("ct.column.sweep"):
            count, no_wrap = sweep_count_guarded(plan, rpw=rpw, rolled=True)
        ok = plan.ok & (plan.rows_rolled <= rpw) & no_wrap
        return CollisionResult(count, None, lo_scene, hi_scene, ok)
    pairs, total, ok = column_fill_pairs(plan, capacity, rpw)
    return CollisionResult(total, pairs, lo_scene, hi_scene, ok)


def _slab_collide(coords, radii, capacity, gx, col_capacity, slab_rows,
                  lo_scene, hi_scene):
    """Slab-engine frame: the dual-dispatch count (one-row sweep kernel +
    residual jobs) or the dual-dispatch fill (one-row masks kernel +
    residual pairs + emission)."""
    plan = plan_slabs(coords, radii, gx, col_capacity, slab_rows)
    if capacity == 0:
        count, d_ok = slab_count_dual(plan)
        return CollisionResult(count, None, lo_scene, hi_scene,
                               plan.ok & d_ok)
    pairs, total, ok = slab_fill_pairs(plan, capacity)
    return CollisionResult(total, pairs, lo_scene, hi_scene, ok)


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


def _grid_collide(coords, radii, capacity, grid_dim, cell_capacity,
                  lo_scene, hi_scene):
    """Grid-engine frame: the dense bins, then the count or the split
    fill (tile counts, scan, hit tiles, emission). ``ok`` is the bins'.
    The count takes ``batched_count`` at an even ``grid_dim`` and the halo
    count otherwise, as the JAX engine routes; on the card both launch the
    one-cell-per-block count kernel."""
    bins, ok, _ = build_grid(coords, radii, grid_dim, cell_capacity)
    if capacity == 0:
        with tracing.span("ct.grid.counts"):
            if bins.dtype == torch.float64:
                # The count kernel reads float32 bins; float64 counts by
                # the plain stencil, as the JAX package's float64 grid
                # count is its XLA one.
                total = tile_counts_plain(bins, grid_dim, cell_capacity) \
                    .sum(dtype=torch.int64)
            elif grid_dim % 2 == 0:
                total = batched.batched_count(bins, grid_dim, cell_capacity)
            else:
                _, total = halo.halo_pairs(bins, grid_dim, cell_capacity, 0)
        return CollisionResult(total, None, lo_scene, hi_scene, ok)
    pairs, total = emit.grid_fill(bins, grid_dim, cell_capacity, capacity)
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
    mean_small = (rsum - top[:nb].sum()) / _scalar(max(n - nb, 1), radii)
    mean_all = rsum / _scalar(n, radii)
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
    with tracing.span("ct.probe"):
        tracing.host_sync("collider._route_hetero_eager")
        s = _hetero_stats(coords, radii, _effective_nb(n, nb)).cpu().tolist()
    r_max, r_small, r_mean_s, r_mean_all = s[:4]
    ext = s[4:7]
    if _predicted_slab_slack(n, r_max, r_mean_all, ext) <= SLAB_SLACK_MAX:
        return None
    gain = (r_mean_all + r_max) / max(r_mean_s + r_small, 1e-30)
    if gain < HETERO_GAIN_MIN:
        return None
    return r_small, r_mean_s, ext


def collide_exact(coords, radii, capacity, method="auto"):
    """One broad-phase step with the exact-knob retries: one ``collide``
    attempt and, when its ``ok`` is False, ``Collider``'s retry ladder.
    Tensors stay on their device; other arrays go to the card. Returns a
    :class:`CollisionResult` whose ``ok`` is True unless every rung
    failed."""
    device = coords.device if isinstance(coords, torch.Tensor) else None
    c = Collider(coords.shape[0], coord_dtype=_numpy_dtype(coords),
                 method=method, device=device)
    coords, radii = c._inputs(coords, radii)
    result = collide(coords, radii, capacity, method=method)
    tracing.host_sync("collider.collide_exact")
    if not bool(result.ok):
        result = c._retry_exact(coords, radii, int(capacity))
    return result


def _numpy_dtype(a):
    if isinstance(a, torch.Tensor):
        return np.dtype(str(a.dtype).removeprefix("torch."))
    return np.asarray(a).dtype


def _resolve_device(device):
    """The card unless the caller names a device: the port has no
    silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return torch.device("cuda")


class Collider:
    """The reference's Collider API (collision.py:32-135): holds (size,
    ngroups, group_size, coord_dtype), exposes ``padded_size`` and
    ``n_nodes``, validates the count-only contract, supports ``resize``,
    and retries a step whose ``ok`` is False with exact knobs read from
    the plans' statistics.

    ``device`` is where the steps run: the card by default (raising when
    there is none), or ``"cpu"``, where each kernel's plain version runs.
    A float64 Collider's steps run the run-expansion fill, and its retry
    provisions the candidates the scene needs (up to ``CAND_MAX``).
    """

    #: Largest candidate bound the float64 retry provisions; past it the
    #: JAX package runs its BVH, which the port does not have yet.
    CAND_MAX = 1 << 28

    def __init__(self, size, ngroups=8, group_size=128,
                 coord_dtype=np.dtype("float32"), method="auto",
                 device=None):
        coord_dtype = np.dtype(coord_dtype)
        if coord_dtype.kind != "f":
            raise ValueError(f"Invalid dtype: {coord_dtype}")
        self._check_params(size, ngroups, group_size)
        self.size = size
        self.ngroups = ngroups
        self.group_size = group_size
        self.coord_dtype = coord_dtype
        #: Engine selection forwarded to :func:`collide`.
        self.method = method
        self.device = _resolve_device(device)

    @staticmethod
    def _check_params(size, ngroups, group_size):
        """The reference's size and shape checks (collision.py:84-119,
        radix.py:61-74): positive integer sizes, group sizes powers of
        two."""
        if not isinstance(size, (int, np.integer)) or size < 1:
            raise ValueError(f"Invalid size: {size!r}")
        if not isinstance(ngroups, (int, np.integer)) or ngroups < 1:
            raise ValueError(f"Invalid ngroups: {ngroups!r}")
        if (not isinstance(group_size, (int, np.integer)) or group_size < 1
                or (group_size & (group_size - 1)) != 0):
            raise ValueError(
                f"group_size must be a positive power of two, got "
                f"{group_size!r}")

    @property
    def n_nodes(self):
        return self.size * 2 - 1

    @property
    def padded_size(self):
        """The reference's sorter-granularity padding (collision.py:
        125-128); nothing is padded here, callers sized buffers by it."""
        return round_up(self.size, 2 * self.group_size)

    def resize(self, size=None, ngroups=None, group_size=None,
               radix_bits=None):
        """Revalidate and apply; on an invalid configuration raise before
        any state changes, so the prior state stays (collision.py:84-119,
        radix.py:93-97)."""
        new_size = self.size if size is None else size
        new_ngroups = self.ngroups if ngroups is None else ngroups
        new_group_size = self.group_size if group_size is None else group_size
        self._check_params(new_size, new_ngroups, new_group_size)
        if radix_bits is not None and (
                not isinstance(radix_bits, (int, np.integer))
                or radix_bits < 1 or 32 % radix_bits != 0
                or 2 ** radix_bits > 2 * new_group_size):
            raise ValueError(f"Invalid radix_bits: {radix_bits!r}")
        self.size = new_size
        self.ngroups = new_ngroups
        self.group_size = new_group_size

    def _inputs(self, coords, radii):
        dtype = getattr(torch, self.coord_dtype.name)
        for a in (coords, radii):
            # A copy from the host, or across device types, waits for the
            # device.
            if not (isinstance(a, torch.Tensor)
                    and a.device.type == self.device.type):
                tracing.host_sync("collider._inputs")
        return (torch.as_tensor(coords, dtype=dtype, device=self.device),
                torch.as_tensor(radii, dtype=dtype, device=self.device))

    @tracing.spanned("ct.get_collisions")
    def get_collisions(self, coords, radii, n_collisions, collisions=True):
        """One frame, as the reference's get_collisions (collision.py:
        130-198).

        Args:
          coords: [size, 3] centers; radii: [size] radii (numpy arrays or
            tensors; they go to the Collider's device).
          n_collisions: pair-buffer capacity.
          collisions: None for count-only mode (with n_collisions == 0);
            None with n_collisions > 0 raises ValueError.

        Returns:
          the int64 count when count-only, else (count, pairs int64
          [n_collisions, 2]).
        """
        if collisions is None and n_collisions > 0:
            raise ValueError("Invalid collisions_buf for n_collisions > 0")
        coords, radii = self._inputs(coords, radii)
        if tuple(coords.shape) != (self.size, 3):
            raise ValueError(
                f"Expected coords of shape {(self.size, 3)}, got "
                f"{tuple(coords.shape)}")
        capacity = int(n_collisions)
        result = collide(coords, radii, capacity, method=self.method)
        tracing.host_sync("collider.get_collisions")
        if not bool(result.ok):
            result = self._retry_exact(coords, radii, capacity)
        if collisions is None or n_collisions == 0:
            return result.count
        return result.count, result.pairs

    @tracing.spanned("ct.retry")
    def _retry_exact(self, coords, radii, capacity):
        """Retry with exact knobs from the engines' statistics.

        Float32: the hetero engine first on a heterogeneous scene, then
        the column engine at the plan's exact capacities and
        rows-per-window rung, then the hetero ladder, then the BVH.
        Float64: the run-expansion fill with the candidate bound the scene
        needs, then the BVH. With every rung failed it returns the best
        attempt, whose ``ok`` is False."""
        if self.coord_dtype != np.float32:
            return self._retry_candidates(coords, radii, capacity)
        site = "collider._retry_exact"
        if self.size > CHUNK:
            tracing.host_sync(site)
            s = _hetero_stats(coords, radii, default_nb(self.size)).tolist()
            r_max, r_small, r_mean_s, r_mean_all = s[:4]
            gain = (r_mean_all + r_max) / max(r_mean_s + r_small, 1e-30)
            if (gain >= HETERO_GAIN_MIN
                    and _predicted_slab_slack(self.size, r_max, r_mean_all,
                                              s[4:7]) > SLAB_SLACK_MAX):
                res = self._hetero_exact(coords, radii, capacity)
                if res is not None:
                    return res
        # The column plan reports the exact column occupancy, slab height
        # and window rows it needs.
        gxy, col_cap, slab_rows = default_column_config(self.size)
        tracing.host_sync(site, 2)
        ext_xy = float((coords.amax(0)[:2] - coords.amin(0)[:2]).max())
        r_max_all = float(radii.max())
        last = None
        for _ in range(6):
            plan = plan_columns(coords, radii, gxy, col_cap, slab_rows,
                                by="retry")
            tracing.host_sync(site, 3)
            need_col = round_up(int(plan.max_col), CHUNK)
            need_slab = int(plan.max_slab_rows) + 2
            need_rpw = int(plan.rows_needed)
            if (need_rpw > RPW_RETRY_MAX and gxy < 256
                    and ext_xy / (2 * gxy) >= 2 * r_max_all):
                # Deep windows on a clustered scene: a finer grid narrows
                # them (cells clamp at 2*r_max, so it stays exact).
                gxy *= 2
                _, col_cap, slab_rows = default_column_config(self.size,
                                                              gxy=gxy)
                continue
            if (need_col <= col_cap and need_slab <= slab_rows
                    and need_rpw <= RPW_LADDER[-1]):
                rpw = next(r for r in RPW_LADDER if r >= need_rpw)
                res = last = collide(
                    coords, radii, capacity, method="column", gxy=gxy,
                    col_capacity=col_cap, slab_rows=slab_rows, rpw=rpw)
                tracing.host_sync(site)
                if bool(res.ok):
                    return res
            # Stats taken under too-small capacities: adopt the exact
            # requirements and plan again (the second plan sees the full
            # window tables).
            col_cap = max(col_cap, need_col)
            slab_rows = max(slab_rows, need_slab)
        res = self._hetero_exact(coords, radii, capacity)
        if res is not None:
            return res
        res = self._bvh_exact(coords, radii, capacity)
        if res is not None:
            return res
        if last is not None:
            return last
        return collide(coords, radii, capacity, method="column", gxy=gxy,
                       col_capacity=col_cap, slab_rows=slab_rows,
                       rpw=RPW_LADDER[-1])

    @tracing.spanned("ct.retry")
    def _retry_candidates(self, coords, radii, capacity):
        """The run-expansion retry: one column step at the scene's exact
        candidate need plus 2% and 1024 (at most ``CAND_MAX``), then the
        BVH, then the honest ``ok=False`` result."""
        gxy = default_column_config(self.size)[0]
        tracing.host_sync("collider._retry_candidates", 2)
        needed = int(candidate_count(coords, radii, gxy))
        cand = min(int(needed * 1.02) + 1024, self.CAND_MAX)
        res = collide(coords, radii, capacity, method="column",
                      cand_capacity=cand)
        if bool(res.ok):
            return res
        bres = self._bvh_exact(coords, radii, capacity)
        return res if bres is None else bres

    def _hetero_exact(self, coords, radii, capacity):
        """Hetero-engine retry with plan-statistic knobs: the slab S-S
        pass at the route's ``gx`` (escalated while only a finer grid can
        help), then column S-S passes at nb, 4*nb and 16*nb parked
        spheres, each with its plan's exact capacities and rows-per-window
        rung. None when no split reaches ``ok`` or the scene is too
        small."""
        if self.size <= 2 * CHUNK:
            return None
        site = "collider._hetero_exact"
        nb0 = default_nb(self.size)
        tracing.host_sync(site)
        stats = _hetero_stats(coords, radii, nb0).tolist()
        route = _hetero_route_knobs(self.size, nb0, stats[1], stats[2],
                                    stats[4:7])
        if self.size >= HETERO_SLAB_MIN and route[0] == "slab":
            gx = route[1]
            lo_s, hi_s = scene_bounds(coords)
            for _ in range(3):
                # A rung of its own outside ``collide`` (it needs the
                # flags), so it opens the span a ``collide`` rung opens.
                with tracing.span("ct.collide"):
                    pairs, total, ok, (_, other_ok) = hetero_collide(
                        coords, radii, capacity, nb=nb0, engine="slab",
                        gx=gx, with_flags=True)
                tracing.host_sync(site)
                if bool(ok):
                    return CollisionResult(total, pairs, lo_s, hi_s, ok)
                tracing.host_sync(site)
                if not bool(other_ok):
                    break
                ngx = _quantize_gx(int(gx * 1.5) + 1)
                if ngx == gx:
                    break
                gx = ngx
        nb_cap = max(CHUNK, (self.size // (2 * CHUNK)) * CHUNK)
        tracing.host_sync(site)
        ext_xy = float((coords.amax(0)[:2] - coords.amin(0)[:2]).max())
        tried = set()
        for nb in (nb0, nb0 * 4, nb0 * 16):
            nb = min(nb, nb_cap)
            if nb in tried:
                continue
            tried.add(nb)
            parked = radii.index_fill(0, _big_indices(radii, nb), -np.inf)
            if nb == nb0 and route[0] == "column":
                gxy, col_cap, slab_rows = route[1:4]
            else:
                gxy, col_cap, slab_rows = default_column_config(self.size)
            tracing.host_sync(site)
            r_small = float(parked.max())
            need_rpw = None
            for _ in range(5):
                plan = plan_columns(coords, parked, gxy, col_cap, slab_rows,
                                    by="retry")
                tracing.host_sync(site, 3)
                need_col = round_up(int(plan.max_col), CHUNK)
                need_slab = int(plan.max_slab_rows) + 2
                need_rpw = int(plan.rows_needed)
                tracing.host_sync(site)
                if bool(plan.ok) and need_rpw <= RPW_RETRY_MAX:
                    break
                if need_rpw > RPW_RETRY_MAX:
                    if gxy < 256 and ext_xy / (2 * gxy) >= 2 * r_small:
                        gxy *= 2
                        _, col_cap, slab_rows = default_column_config(
                            self.size, gxy=gxy)
                        continue
                    need_rpw = None     # this split cannot fit; park more
                    break
                col_cap = max(col_cap, need_col)
                slab_rows = max(slab_rows, need_slab)
            if need_rpw is None or need_rpw > RPW_RETRY_MAX:
                continue
            rpw = next(r for r in RPW_LADDER if r >= max(need_rpw, 1))
            res = collide(coords, radii, capacity, method="hetero", nb=nb,
                          rpw=rpw, gxy=gxy, col_capacity=col_cap,
                          slab_rows=slab_rows)
            tracing.host_sync(site)
            if bool(res.ok):
                return res
        return None

    def _bvh_exact(self, coords, radii, capacity):
        """The last rung, the always-exact BVH engine: None until the LBVH
        is ported (ROADMAP.md, modules item 11)."""
        return None
