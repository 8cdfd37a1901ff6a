"""The column plan on the card: bounds and scalars, uint32 keys, a stable
sort on the key's bits, the column starts, one pass that writes the
stream, and one pass that writes the window tables and the retry's
statistics.

Replaces no TPU kernel: the JAX package builds the plan with XLA ops
(collision_tpu/columns.py: plan_columns). On a CUDA tensor the wrapper
enqueues the chain of ``csrc/column_plan.cu`` on the current stream (one
entry point, six kernels and cub's radix sort, no host sync; its bounds,
packing, z quantizer, sort and column starts are
``csrc/bucket_sort.cuh``'s, shared with the slab plan and the grid bins);
on a CPU tensor it runs ``columns.plan_columns_plain``, the same plan bit
for bit.
"""

import torch

from ..columns import CHUNK, LANE, ColumnPlan, _zbits
from ..columns import plan_columns_plain as build_plan_plain
from . import _build

__all__ = ["build_plan", "build_plan_plain"]


def build_plan(coords, radii, gxy, col_capacity, slab_rows):
    """The :class:`columns.ColumnPlan` that ``columns.plan_columns``
    returns. Raises ValueError on any device, before any launch, for no
    sphere or 2^31 of them, a ``gxy`` whose extended column ids leave no
    bit of z in a 32-bit key, a ``col_capacity`` below 1, or a stream too
    short for the spheres."""
    coords, radii, n = _build.spheres(coords, radii)
    rows = -(-n // LANE) + slab_rows + 2
    if (not 1 <= n < 2 ** 31 or gxy < 1 or _zbits(gxy) < 1
            or col_capacity < 1 or rows * LANE < n):
        raise ValueError(f"plan_columns takes 1 to 2^31 - 1 spheres, gxy "
                         f"in [1, 46340], a positive col_capacity and "
                         f"slab_rows >= -2, got n={n}, gxy={gxy}, "
                         f"col_capacity={col_capacity}, "
                         f"slab_rows={slab_rows}")
    if not coords.is_cuda:
        return build_plan_plain(coords, radii, gxy, col_capacity, slab_rows)
    if coords.dtype != torch.float32 or radii.dtype != torch.float32:
        raise ValueError(f"coords and radii must be float32, got "
                         f"{coords.dtype} and {radii.dtype}")
    dev = coords.device
    zbits = _zbits(gxy)
    mc = -(-col_capacity // CHUNK)
    stream = torch.empty((rows, 8, LANE), dtype=torch.float32, device=dev)
    starts = torch.empty(((gxy + 1) * gxy + 1,), dtype=torch.int32,
                         device=dev)
    w0 = torch.empty((gxy, gxy * mc * 5), dtype=torch.int32, device=dev)
    wcap = torch.empty((gxy, gxy * mc * 5), dtype=torch.int32, device=dev)
    # rows_needed, rows_rolled, max_col, max_slab_rows
    stats = torch.empty((4,), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    work = torch.empty(
        (_build.workspace_bytes("column_plan_workspace", n, gxy, zbits),),
        dtype=torch.uint8, device=dev)
    _build.launch("column_plan_launch", coords.data_ptr(), radii.data_ptr(),
                  n, gxy, zbits, mc, col_capacity, slab_rows, rows,
                  work.data_ptr(), work.numel(), stream.data_ptr(),
                  starts.data_ptr(), w0.data_ptr(), wcap.data_ptr(),
                  stats.data_ptr(), ok.data_ptr())
    _build.LAUNCHES["column_plan"] += 1
    return ColumnPlan(stream, starts, w0, wcap, ok, stats[2], stats[3],
                      stats[0], stats[1], n=n, gxy=gxy, mc=mc,
                      slab_rows=slab_rows)
