"""Column-sweep broad phase: the plan (collision_tpu/columns.py).

Spheres sort by ``column_id << zbits | quantize(z)`` over a gxy x gxy
grid of xy-columns at least 2*r_max wide, so each column is a z-sorted
run of the sorted stream. For every 64-sphere chunk of a column the
z-window of possible partners in each of the 5 half-stencil columns
(``COLUMN_OFFSETS``) is found with one batched composite-key
searchsorted. Windows are conservative supersets, the kernels' box test
is exact, and capacity overflows are detected (``ok=False``), never
silently wrong.

The stream, the z quantizer and the float32 helpers are shared with the
slab engine (slabs.py). Sort keys and positions are int64 here where the
JAX plan has uint32: torch's uint32 has no ``<<`` and no
``searchsorted``.
"""

from typing import NamedTuple

import numpy as np
import torch

from .ops import scene_bounds, sorted_bucket_starts
from .utils import round_up

#: xy half-stencil: (dx, dy) column offsets covering each unordered
#: column pair once; the self offset pairs with a j > i constraint.
COLUMN_OFFSETS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))

#: Spheres per a-chunk (one chunk = one banded tile row group).
CHUNK = 64

#: Sphere rows per stream row (lanes).
LANE = 128


def _quantize(z, lo, scale, zmax):
    """Monotone float -> integer quantization, as int64.

    ``(z - lo) * scale`` is computed in the input's float type, clamped
    to [0, 2^32] (the JAX package's uint32 cast saturates there),
    truncated to an integer, and clamped at ``zmax`` in the integer
    domain: float32 rounds ``zmax = 2^k - 1`` up, which would let a max-z
    sphere spill into the column bits of the packed sort key.
    """
    q = torch.clamp((z - lo) * scale, 0.0, 2.0 ** 32)
    return torch.clamp_max(q.to(torch.int64), zmax)


def _scalar(v, like):
    """``v`` as a 0-dim tensor of ``like``'s float type and device.

    Divisors and dividends become tensors: torch turns ``number /
    tensor`` into ``reciprocal() * number``, which is not IEEE division
    and disagrees with the JAX plans in the last bit.
    """
    return torch.tensor(float(v), dtype=like.dtype, device=like.device)


def build_stream(comps, ids_s, channel7, rows):
    """The [rows, 8, 128] float32 stream: the six box components, the id
    bit patterns, and ``channel7`` (int32 bit patterns), +inf past the
    n sorted spheres.

    Built in int32 so channel 6 carries the id bit patterns (small ids
    are float32 denormals) through no float arithmetic at all.
    """
    n = ids_s.shape[0]
    bits = [c.view(torch.int32) for c in comps]
    bits += [ids_s.to(torch.int32), channel7]
    inf_bits = int(np.float32(np.inf).view(np.int32))
    flat = torch.full((8, rows * LANE), inf_bits, dtype=torch.int32,
                      device=ids_s.device)
    flat[:, :n] = torch.stack(bits)
    return flat.view(8, rows, LANE).permute(1, 0, 2).contiguous() \
        .view(torch.float32)


def chunk_z_ranges(starts, nbuckets, mc, zlo, zhi):
    """(min zlo, max zhi) over the members of each chunk [nbuckets, mc]:
    chunk k of bucket b holds sorted spheres [starts[b] + 64k,
    min(starts[b] + 64k + 64, starts[b + 1])); empty chunks give
    (+inf, -inf). Min and max are exact, so this equals the JAX plans'
    strip gathers bit for bit."""
    dev = zlo.device
    n = zlo.shape[0]
    g0 = starts[:nbuckets, None].long() \
        + torch.arange(mc, device=dev) * CHUNK                # [nb, mc]
    ends = starts[1:nbuckets + 1, None].long()
    pos = g0[..., None] + torch.arange(CHUNK, device=dev)     # [nb, mc, 64]
    inwin = pos < ends[..., None]
    pos = pos.clamp(max=n - 1)
    inf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    return (torch.where(inwin, zlo[pos], inf).amin(-1),
            torch.where(inwin, zhi[pos], -inf).amax(-1))


class ColumnPlan(NamedTuple):
    """Everything the column sweep kernels need, plus host-retry stats.

    The JAX plan's ``slab_r0`` (the first stream row of each x-slab) is
    not built: only the TPU kernels' DMA ring reads it.
    """

    stream: torch.Tensor      # [Rp, 8, 128] f32: xlo ylo zlo xhi yhi zhi id pad
    starts: torch.Tensor      # int32[(gxy+1)*gxy + 1] column start indices
    w0: torch.Tensor          # int32[gxy, gxy*mc*5] window starts (global)
    wcap: torch.Tensor        # int32[gxy, gxy*mc*5] window lengths
    ok: torch.Tensor          # bool: capacities held (result exact iff True)
    max_col: torch.Tensor     # int32 stats for host retry
    max_slab_rows: torch.Tensor
    rows_needed: torch.Tensor  # int32: max stream rows any window spans
    rows_rolled: torch.Tensor  # int32: max ceil(window/128) of any window
    n: int
    gxy: int
    mc: int
    slab_rows: int


def default_column_config(n, target_occupancy=1500, gxy=None):
    """(gxy, col_capacity, slab_rows) from n.

    Columns of ~1500 spheres; capacities ~6 Poisson sigmas above the
    uniform mean. Pass ``gxy`` to size the capacities for a chosen grid.
    """
    if gxy is None:
        gxy = int(np.clip(round((n / target_occupancy) ** 0.5), 1, 64))
    occ = n / (gxy * gxy)
    col_cap = int(round_up(int(occ + 6 * occ ** 0.5 + 16), CHUNK))
    col_cap = min(col_cap, int(round_up(n, CHUNK)))
    slab = n / gxy
    slab_rows = int((slab + 6 * slab ** 0.5 + 16) // LANE) + 4
    slab_rows = min(slab_rows, n // LANE + 4)
    return gxy, col_cap, slab_rows


def _zbits(gxy):
    # +1 so (ncols_ext << zbits) + zmax + 1 never leaves 32 bits (the
    # upper window threshold of the last column at max z).
    ncols_ext = (gxy + 1) * gxy
    return 32 - max(int(np.ceil(np.log2(ncols_ext + 1))), 1)


def _column_sort(coords, radii, gxy):
    """Sort spheres by ``column_id << zbits | quantize(z)``.

    Returns (key_s, order, c_s [n, 3], r_s, lo_s, zscale, r_max): the
    sorted int64 keys, the original ids in sorted order, the sorted
    centers and radii, and the quantization parameters. A stable sort of
    the keys plus one gather equals the JAX package's stable
    multi-operand ``lax.sort``. Float32 or float64: the geometry and
    ``zscale`` keep the input's type, as in the JAX package (float64
    computes ``zmax / zext`` in float64, where float32 rounds zmax up).
    """
    zbits = _zbits(gxy)
    zmax = (1 << zbits) - 1
    lo_s, hi_s = scene_bounds(coords)
    r_max = torch.amax(radii)
    ext = hi_s - lo_s
    one = _scalar(1.0, coords)
    # Column size >= 2*r_max per axis: colliding pairs land in the same
    # or an adjacent column.
    sxy = torch.maximum(2 * r_max, ext[:2] / _scalar(gxy, coords))
    sxy = torch.where(sxy > 0, sxy, one)
    cxy = torch.clamp(((coords[:, :2] - lo_s[:2]) / sxy).to(torch.int32),
                      0, gxy - 1).to(torch.int64)
    col = cxy[:, 0] * gxy + cxy[:, 1]
    zext = torch.where(ext[2] > 0, ext[2], one)
    zscale = _scalar(zmax, coords) / zext
    zq = _quantize(coords[:, 2], lo_s[2], zscale, zmax)
    key_s, order = torch.sort((col << zbits) | zq, stable=True)
    return (key_s, order, coords.index_select(0, order),
            radii.index_select(0, order), lo_s, zscale, r_max)


def plan_columns(coords, radii, gxy, col_capacity, slab_rows):
    """Sort by (column, z) and precompute the column sweep kernels'
    inputs. ``coords`` [n, 3] and ``radii`` [n] are float32 on one
    device; the plan lives there too."""
    dev = coords.device
    n = coords.shape[0]
    zbits = _zbits(gxy)
    zmax = (1 << zbits) - 1
    mc = -(-col_capacity // CHUNK)
    ncols = gxy * gxy
    ncols_ext = (gxy + 1) * gxy

    key_s, order, c_s, r_s, lo_s, zscale, r_max = _column_sort(
        coords, radii, gxy)
    zext = _scalar(zmax, zscale) / zscale
    col_s = key_s >> zbits

    # Column starts over the extended id range: the pad x-row gxy stays
    # empty, which makes the dx=1 offsets of the last x-row vacuous.
    starts = sorted_bucket_starts(
        col_s, torch.arange(ncols_ext + 1, device=dev)).to(torch.int32)

    # --- stream [Rp, 8, 128]; channel 7 is +inf ---
    R = -(-n // LANE)
    x_s, y_s, z_s = c_s.unbind(1)
    zlo, zhi = z_s - r_s, z_s + r_s
    inf_bits = int(np.float32(np.inf).view(np.int32))
    stream = build_stream(
        [x_s - r_s, y_s - r_s, zlo, x_s + r_s, y_s + r_s, zhi], order,
        torch.full((n,), inf_bits, dtype=torch.int32, device=dev),
        R + slab_rows + 2)

    # --- exact per-chunk z ranges ---
    lo_chunk, hi_chunk = chunk_z_ranges(starts, ncols, mc, zlo, zhi)
    g0 = starts[:ncols, None].long() \
        + torch.arange(mc, device=dev) * CHUNK                # [ncols, mc]
    valid = g0 < starts[1:ncols + 1, None]

    # Window thresholds in quantized-z space: conservative supersets by
    # monotonicity. Clamp to the finite scene range first (empty chunks
    # carry +-inf).
    zhi_scene = lo_s[2] + zext
    qlo = _quantize(torch.clamp(lo_chunk - r_max, lo_s[2], zhi_scene),
                    lo_s[2], zscale, zmax)
    qhi = _quantize(torch.clamp(hi_chunk + r_max, lo_s[2], zhi_scene),
                    lo_s[2], zscale, zmax)

    # One batched composite-key searchsorted for all (offset, lo/hi)
    # thresholds.
    c_idx = torch.arange(ncols, device=dev)
    col_x, col_y = c_idx // gxy, c_idx % gxy
    key_q, valid_q = [], []
    for dx, dy in COLUMN_OFFSETS:
        yb = col_y + dy
        cb = (((col_x + dx) * gxy + torch.clamp(yb, 0, gxy - 1))
              << zbits)[:, None]
        key_q += [cb + qlo, cb + qhi + 1]
        valid_q.append(((yb >= 0) & (yb < gxy))[:, None] & valid)
    all_pos = sorted_bucket_starts(
        key_s, torch.stack(key_q).reshape(-1)).reshape(10, ncols, mc)

    w0_list, wcap_list = [], []
    for off, (dx, dy) in enumerate(COLUMN_OFFSETS):
        w0 = all_pos[2 * off]
        if (dx, dy) == (0, 0):
            # Self column: the j > i dedup kills everything below the
            # chunk start, so clip the window there.
            w0 = torch.maximum(w0, g0)
        w0 = torch.where(valid_q[off], w0, 0)
        w0_list.append(w0)
        wcap_list.append(torch.where(
            valid_q[off], (all_pos[2 * off + 1] - w0).clamp_min(0), 0))
    w0_tab = torch.stack(w0_list, -1)                  # [ncols, mc, 5]
    wcap_tab = torch.stack(wcap_list, -1)
    # Stream rows a window spans from its aligned row, and 128-lane rows
    # it spans from its own start.
    rows_needed = torch.amax((w0_tab % LANE + wcap_tab + LANE - 1) // LANE)
    rows_rolled = torch.amax((wcap_tab + LANE - 1) // LANE)
    w0_tab = w0_tab.reshape(gxy, gxy * mc * 5).to(torch.int32)
    wcap_tab = wcap_tab.reshape(gxy, gxy * mc * 5).to(torch.int32)

    # --- capacity checks (host retry stats; never silently wrong) ---
    max_col = torch.amax(starts[1:ncols + 1] - starts[:ncols])
    xs = torch.arange(gxy, device=dev)
    slab_rows_needed = (starts[(xs + 1) * gxy] + (LANE - 1)) // LANE \
        - starts[xs * gxy] // LANE
    max_slab = torch.amax(slab_rows_needed)
    ok = (max_col <= col_capacity) & (max_slab + 2 <= slab_rows)
    return ColumnPlan(stream, starts, w0_tab, wcap_tab, ok, max_col,
                      max_slab, rows_needed.to(torch.int32),
                      rows_rolled.to(torch.int32), n=n, gxy=gxy, mc=mc,
                      slab_rows=slab_rows)


def plan_from_numpy(d, device):
    """The port's :class:`ColumnPlan` from the JAX ``ColumnPlan``'s
    fields given as numpy arrays and ints (``d`` maps field name to
    value), so both packages' kernels can run on one identical plan."""
    def t(name):
        return torch.from_numpy(np.array(d[name])).to(device)

    return ColumnPlan(
        t("stream"), t("starts"), t("w0"), t("wcap"), t("ok"),
        t("max_col"), t("max_slab_rows"), t("rows_needed"),
        t("rows_rolled"), n=int(d["n"]), gxy=int(d["gxy"]),
        mc=int(d["mc"]), slab_rows=int(d["slab_rows"]))
