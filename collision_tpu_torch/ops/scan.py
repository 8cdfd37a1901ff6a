"""Inclusive prefix sum (collision_tpu/ops/scan.py)."""

import torch


def inclusive_scan(values):
    """Inclusive prefix sum of a 1-D tensor in its own dtype.

    ``torch.cumsum`` widens int32 to int64 unless told otherwise; the
    JAX package's scans are modular in the input dtype, so the dtype is
    pinned.
    """
    return torch.cumsum(values, dim=0, dtype=values.dtype)
