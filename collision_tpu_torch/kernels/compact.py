"""Stream compaction: ascending indices of the set elements of a mask.

Port of collision_tpu/kernels/compact.py. On a CUDA tensor the wrapper
launches the one-pass compaction of ``csrc/compact.cu`` (a decoupled
look-back over 4096-element tiles), which never waits for the host
(``torch.nonzero`` does); on a CPU tensor it runs the plain PyTorch
version beside it.
"""

import functools

import torch

from . import _build

#: Sentinel filling unused output slots (a uint32 value, held in int64).
NO_INDEX = 0xFFFFFFFF

#: Sentinel slots per block that fills them, and the most such blocks.
_FILL_SLOTS = 1 << 13
_MAX_FILL_BLOCKS = 1024

#: The look-back's epochs, 30-bit tags that the kernel moves on itself;
#: when they wrap, it zeroes its status words (once in 2^30 - 1 calls).
_EPOCHS = (1 << 30) - 1

#: (device index, stream) -> that stream's look-back state: int64 words
#: [ticket, blocks done, epoch, one status word a tile], zeroed once. A
#: state is used in its stream's order only, so calls on two streams never
#: share one.
_STATES = {}


@functools.cache
def _tile():
    return _build.library().compact_tile()


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
    of True elements even past ``capacity``.

    On the card both are views of one int64 buffer of ``capacity + 1``
    slots, which the kernel writes whole: no op runs on it after the
    launch.
    """
    if mask.dtype != torch.bool:
        raise ValueError(f"compact_mask takes a bool mask, got {mask.dtype}")
    flat = mask.reshape(-1)
    if not flat.is_cuda:
        return compact_mask_plain(flat, capacity)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    n = flat.numel()
    if n >= 2 ** 31:
        raise ValueError("compact_mask takes fewer than 2^31 elements")
    nblk = max(1, -(-n // _tile()))
    nfill = min(-(-capacity // _FILL_SLOTS), _MAX_FILL_BLOCKS)
    device = flat.get_device()
    stream = _build.current_stream(device)
    state = _STATES.get((device, stream))
    if state is None or state.numel() - 3 < nblk:
        state = _STATES[device, stream] = torch.zeros(
            (3 + max(nblk, 256),), dtype=torch.int64, device=flat.device)
    out = torch.empty((capacity + 1,), dtype=torch.int64, device=flat.device)
    indices, total = out[:capacity], out[capacity]
    _build.launch_on(stream, "compact_launch", flat.data_ptr(), n, nblk,
                     nfill, capacity, out.data_ptr(), state.data_ptr(),
                     state.numel() - 3, _EPOCHS)
    _build.LAUNCHES["compact_mask"] += 1
    return indices, total
