"""Mask-buffer grouping shared by the sweep engines
(collision_tpu/kernels/sweep.py). Only ``mask_groups`` is ported; the
column engine's kernels are still queued in ROADMAP.md."""


def mask_groups(mc):
    """(KG, NG): chunks per mask group and number of groups.

    The layout of the packed mask buffer, kept from the JAX package so
    the two buffers compare bit for bit: KG is at most ~2 MiB of words
    per group on the TPU, rounded up to a multiple of 4. Only the
    one-row slab layout (one rolled row per window, 5 * 1024 words per
    chunk) is ported; the JAX ``rpw`` retry rows come with the retry
    ladder (ROADMAP.md).
    """
    kg = max(1, (2 << 20) // (5 * 1024))
    kg = min(kg, mc)
    kg = -(-kg // 4) * 4
    return kg, -(-mc // kg)
