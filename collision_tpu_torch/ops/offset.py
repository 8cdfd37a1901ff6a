"""Sorted-run offsets (collision_tpu/ops/offset.py).

The JAX package resolves searchsorted through a subsample pyramid of
dense compares because a TPU binary search serializes scalar gathers; a
GPU binary search does not, so the port calls ``torch.searchsorted``.
"""

import torch


def sorted_bucket_starts(values, buckets):
    """``searchsorted(values, buckets, side='left')``: for each bucket,
    the count of entries of the sorted 1-D ``values`` below it.

    Returns int64. Keys that are uint32 in the JAX package are carried
    as int64 here: torch has no ``searchsorted`` for uint32.
    """
    return torch.searchsorted(values, buckets.to(values.dtype), side="left")
