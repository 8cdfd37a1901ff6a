"""Dense uniform-grid broad phase: the bins and the stencil count
(collision_tpu/grid.py).

Spheres are binned into a dense ``[gd+2]^3 x [cell_capacity, 8]`` grid of
cells at least 2*r_max wide, so every colliding pair sits in the same or
an adjacent cell. Each unordered cell pair is visited once: the self
tile with its upper triangle (j > i), then the 13 lexicographically
positive neighbour offsets. A cell past ``cell_capacity`` is reported
(``ok=False``), never silently wrong.

The JAX package's ``build_grid(method=...)`` and its TPU "compact" branch
(a Pallas compaction plus a wide-block gather) are not ported: both of
its methods give the same bins. On a CUDA tensor the bins come from the
hand-written chain of ``kernels.grid_bins`` (bounds, cell keys, a stable
sort on the key's bits, one pass that writes every slot, no host sync);
on a CPU tensor from :func:`build_grid_plain`, a sort and one row
scatter, the same bins bit for bit.
"""

from typing import NamedTuple

import numpy as np
import torch

from . import tracing

#: Neighbor offsets covering each unordered cell pair once: (0,0,0) handled
#: separately with an upper-triangle mask; these 13 are the lexicographically
#: positive half of the 26-neighborhood.
_HALF_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (0, 1)
    for dy in ((-1, 0, 1) if dx == 1 else (0, 1))
    for dz in ((-1, 0, 1) if (dx == 1 or dy == 1) else (1,))
)
assert len(_HALF_OFFSETS) == 13

#: The 14 tile offsets in tile order: o = 0 the self tile, then
#: ``_HALF_OFFSETS``.
TILE_OFFSETS = ((0, 0, 0),) + _HALF_OFFSETS

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


class GridCounts(NamedTuple):
    """Count-pass output: total pairs + per-(offset, cell) tile counts."""

    total: torch.Tensor         # int64 0-dim: exact pair count
    ok: torch.Tensor            # bool: False if any cell overflowed
    tile_counts: torch.Tensor   # int32[14, G]: pairs per offset per cell


def id_bits(lane):
    """The sphere ids stored in the bins' lane 3 (a tensor of it), as
    uint32 values in int64: the bits, never a float conversion (small ids
    are denormals)."""
    return lane.contiguous().view(_INT_OF[lane.dtype]).long() & 0xFFFFFFFF


#: ``build_grid``'s methods: the JAX package's binning paths. The port
#: has one path on each device and takes every name for it.
BUILD_METHODS = ("auto", "scatter", "compact")


@tracing.spanned("ct.grid.bins")
def build_grid(coords, radii, grid_dim, cell_capacity, method="auto"):
    """Bin spheres into a dense padded grid.

    Returns (bins, ok, ids_sorted): ``bins`` is [grid_dim+2, grid_dim+2,
    grid_dim+2, cell_capacity, 8] in the coordinates' type with a +inf
    halo border, lanes 0-2 the AABB lo, lane 3 the sphere id's bits, lanes
    4-6 the AABB hi, lane 7 zero; empty slots are +inf rows. ``ok`` is
    False when a cell holds more than ``cell_capacity`` spheres (those
    past it are dropped). ``ids_sorted`` (int64) are the sphere ids in
    cell order, stable within a cell.

    ``method`` ("auto", "scatter" or "compact") picks a binning path in
    the JAX package; every one gives the same bins there and here, where
    one path on each device serves them all: the kernel chain of
    ``kernels.grid_bins`` on a CUDA tensor, :func:`build_grid_plain` on a
    CPU tensor.
    """
    if method not in BUILD_METHODS:
        raise ValueError(f"method {method!r} not in {BUILD_METHODS}")
    from .kernels import grid_bins

    return grid_bins.build_bins(coords, radii, grid_dim, cell_capacity)


def build_grid_plain(coords, radii, grid_dim, cell_capacity):
    """Plain PyTorch version of :func:`build_grid`: one stable sort by cell
    id, one row scatter. The CPU route, and the card's reference.

    Its divisor is made on the tensors' device and counted as no host
    sync: on the CPU route it waits for nothing, and a CUDA tensor's
    route is the kernel chain. Takes no sphere too (all +inf bins).
    """
    dev = coords.device
    dt = coords.dtype
    n = coords.shape[0]
    gd, M = grid_dim, cell_capacity
    gp = gd + 2
    if n == 0:
        return (torch.full((gp, gp, gp, M, 8), np.inf, dtype=dt, device=dev),
                torch.ones((), dtype=torch.bool, device=dev),
                torch.zeros((0,), dtype=torch.int64, device=dev))

    lo_s = coords.amin(0)
    hi_s = coords.amax(0)
    # The divisor is a tensor: torch on the card divides by a Python number
    # through its reciprocal, which is not IEEE division and would bin
    # spheres into other cells than the JAX package.
    gd_t = torch.tensor(float(gd), dtype=dt, device=dev)
    s = torch.maximum(2 * radii.amax(), (hi_s - lo_s) / gd_t)
    s = torch.where(s > 0, s, torch.ones_like(s))
    cxyz = torch.clamp(((coords - lo_s) / s).to(torch.int32), 0, gd - 1).long()
    cell = (cxyz[:, 0] * gd + cxyz[:, 1]) * gd + cxyz[:, 2]

    # One stable sort by cell id; the payloads follow by one gather.
    cell_s, ids_s = torch.sort(cell, stable=True)
    c_s = coords.index_select(0, ids_s)
    r_s = radii.index_select(0, ids_s)[:, None]
    # Built in the integer domain, so the id lane carries the id's bits
    # through no float arithmetic.
    it = _INT_OF[dt]
    ids_bits = ids_s.to(it)[:, None]
    row = torch.cat([(c_s - r_s).view(it), ids_bits, (c_s + r_s).view(it),
                     torch.zeros_like(ids_bits)], dim=1).view(dt)

    # Rank within the cell: distance from the cell's first sorted index.
    rank = torch.arange(n, device=dev) - torch.searchsorted(cell_s, cell_s)
    ok = (rank < M).all()

    # One row scatter straight into the padded grid; rows past the
    # capacity land in one dump row, cut off afterwards.
    x, y, z = cell_s // (gd * gd), cell_s // gd % gd, cell_s % gd
    target = (((x + 1) * gp + y + 1) * gp + z + 1) * M + rank
    target = torch.where(rank < M, target, gp ** 3 * M)
    bins = torch.full((gp ** 3 * M + 1, 8), np.inf, dtype=dt, device=dev)
    bins[target] = row
    return bins[:-1].view(gp, gp, gp, M, 8), ok, ids_s


def _tile_overlap(a, b):
    """Dense strict-overlap mask between two [..., M, 8] tiles.

    Returns [..., M, M] bool: entry (i, j) = AABB i of ``a`` strictly
    overlaps AABB j of ``b`` (collision.cl:164-166 semantics). +inf pad
    rows never match (their lo is +inf, never < any hi).
    """
    mask = None
    for c in range(3):
        m = ((a[..., :, None, 4 + c] > b[..., None, :, c])
             & (a[..., :, None, c] < b[..., None, :, 4 + c]))
        mask = m if mask is None else mask & m
    return mask


def tile_counts_plain(bins, grid_dim, cell_capacity):
    """int32[14, G]: the pairs of each tile (offset o, cell (x*gd + y)*gd
    + z), by the dense stencil in slabs of x (bounded memory)."""
    gd, M = grid_dim, cell_capacity
    step = max(1, (1 << 25) // (gd * gd * M * M))
    tri = torch.ones((M, M), dtype=torch.bool, device=bins.device).triu(1)
    out = []
    for x0 in range(0, gd, step):
        x1 = min(gd, x0 + step)
        center = bins[1 + x0:1 + x1, 1:-1, 1:-1]
        slab = []
        for o, (dx, dy, dz) in enumerate(TILE_OFFSETS):
            nb = bins[1 + x0 + dx:1 + x1 + dx, 1 + dy:1 + dy + gd,
                      1 + dz:1 + dz + gd]
            mask = _tile_overlap(center, nb)
            if o == 0:
                mask &= tri
            slab.append(mask.sum((-1, -2)).reshape(-1))
        out.append(torch.stack(slab))
    return torch.cat(out, dim=1).to(torch.int32)


def grid_count(coords, radii, grid_dim=32, cell_capacity=64):
    """Count colliding pairs with the dense stencil. Returns GridCounts.

    The tile counts come from ``kernels.emit.halo_tile_counts`` (its
    kernel on a CUDA tensor, the plain stencil on a CPU tensor), reordered
    from its [gd^2, tile_pad] layout to [14, G].
    """
    from .kernels import emit

    gd = grid_dim
    bins, ok, _ = build_grid(coords, radii, gd, cell_capacity)
    tc = emit.halo_tile_counts(bins, gd, cell_capacity)
    tile_counts = tc[:, :14 * gd].reshape(gd * gd, gd, 14).permute(2, 0, 1) \
        .reshape(14, gd ** 3)
    return GridCounts(tile_counts.sum(dtype=torch.int64), ok, tile_counts)
