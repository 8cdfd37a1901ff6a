"""The slab plan on the card: bounds and scalars, uint32 keys, a stable
sort on the key's bits, one pass that writes the stream, and the slab
starts and window tables.

Replaces no TPU kernel: the JAX package builds the plan with XLA ops
(collision_tpu/slabs.py: plan_slabs). On a CUDA tensor the wrapper
enqueues the chain of ``csrc/slab_plan.cu`` on the current stream (one
entry point, six kernels and cub's radix sort, no host sync; its bounds,
packing, sort and slab starts are ``csrc/bucket_sort.cuh``'s, shared with
the grid bins); on a CPU tensor it runs ``slabs.plan_slabs_plain``, the
same plan bit for bit.
"""

import torch

from ..slabs import CHUNK, LANE, SlabPlan, _xbits_z, stream_rows
from ..slabs import plan_slabs_plain as build_plan_plain
from . import _build

__all__ = ["build_plan", "build_plan_plain"]


def build_plan(coords, radii, gx, col_capacity, slab_rows):
    """The :class:`slabs.SlabPlan` that ``slabs.plan_slabs`` returns."""
    if not coords.is_cuda:
        return build_plan_plain(coords, radii, gx, col_capacity, slab_rows)
    if coords.dtype != torch.float32 or radii.dtype != torch.float32:
        raise ValueError(f"coords and radii must be float32, got "
                         f"{coords.dtype} and {radii.dtype}")
    coords, radii, n = _build.spheres(coords, radii)
    if not 1 <= n < 2 ** 31 or not 1 <= gx <= 4096 or col_capacity < 1:
        raise ValueError(f"plan_slabs takes 1 to 2^31 - 1 spheres, gx in "
                         f"[1, 4096] and a positive col_capacity, got n={n}, "
                         f"gx={gx}, col_capacity={col_capacity}")
    dev = coords.device
    zbits = _xbits_z(gx)
    mc = -(-col_capacity // CHUNK)
    rows = stream_rows(n, slab_rows)
    stream = torch.empty((rows, 8, LANE), dtype=torch.float32, device=dev)
    starts = torch.empty((gx + 2,), dtype=torch.int32, device=dev)
    w0 = torch.empty((gx, mc * 2), dtype=torch.int32, device=dev)
    wcap = torch.empty((gx, mc * 2), dtype=torch.int32, device=dev)
    # rows_rolled, max_col, max_slab_rows
    maxima = torch.empty((3,), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    diag_thr = torch.empty((1,), dtype=torch.float32, device=dev)
    work = torch.empty(
        (_build.workspace_bytes("slab_plan_workspace", n, gx, zbits),),
        dtype=torch.uint8, device=dev)
    _build.launch("slab_plan_launch", coords.data_ptr(), radii.data_ptr(), n,
                  gx, zbits, mc, col_capacity, slab_rows, rows,
                  work.data_ptr(), work.numel(), stream.data_ptr(),
                  starts.data_ptr(), w0.data_ptr(), wcap.data_ptr(),
                  maxima.data_ptr(), ok.data_ptr(), diag_thr.data_ptr())
    _build.LAUNCHES["slab_plan"] += 1
    return SlabPlan(stream, starts, w0, wcap, ok, maxima[1], maxima[2],
                    maxima[0], diag_thr, n=n, gx=gx, mc=mc,
                    slab_rows=slab_rows)
