"""Stream compaction: ascending indices of the set elements of a mask.

Port of collision_tpu/kernels/compact.py. On a CUDA tensor the wrapper
launches the two-pass block-scan compaction of ``csrc/compact.cu``, which
never waits for the host (``torch.nonzero`` does); on a CPU tensor it
runs the plain PyTorch version beside it.
"""

import torch

from . import _build

#: Sentinel filling unused output slots (a uint32 value, held in int64).
NO_INDEX = 0xFFFFFFFF

def compact_mask_plain(mask, capacity):
    """Plain PyTorch version of :func:`compact_mask`."""
    idx = torch.nonzero(mask.reshape(-1)).flatten()
    out = torch.full((capacity,), NO_INDEX, dtype=torch.int64,
                     device=mask.device)
    kept = min(capacity, idx.numel())
    out[:kept] = idx[:kept]
    return out, torch.tensor(idx.numel(), device=mask.device)


def compact_mask(mask, capacity):
    """(indices int64[capacity], total int64): the ascending flat indices
    of the True elements of the bool ``mask``, the first ``capacity`` of
    them kept and the rest of the slots 0xFFFFFFFF, and the true number
    of True elements even past ``capacity``."""
    if mask.dtype != torch.bool:
        raise ValueError(f"compact_mask takes a bool mask, got {mask.dtype}")
    flat = mask.reshape(-1)
    if not flat.is_cuda:
        return compact_mask_plain(flat, capacity)
    flat = flat.contiguous().view(torch.uint8)
    n = flat.numel()
    if n >= 2 ** 31:
        raise ValueError("compact_mask takes fewer than 2^31 elements")
    nblk = max(1, -(-n // _build.library().compact_tile()))
    counts = torch.empty((nblk,), dtype=torch.int32, device=flat.device)
    total = torch.empty((1,), dtype=torch.int32, device=flat.device)
    out = torch.empty((capacity,), dtype=torch.int32, device=flat.device)
    _build.launch("compact_launch", flat.data_ptr(), n, capacity,
                  counts.data_ptr(), total.data_ptr(), out.data_ptr(), nblk)
    _build.LAUNCHES["compact_mask"] += 1
    return out.long() & 0xFFFFFFFF, total[0].long()
