"""Small size helpers (collision_tpu/utils/dtypes.py)."""


def round_up(x: int, base: int) -> int:
    """Round ``x`` up to the next multiple of ``base``."""
    if base <= 0:
        raise ValueError("base must be positive")
    return -(-x // base) * base
