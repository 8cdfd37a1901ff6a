"""The least work of one frame, whatever implements it.

A frame reads every sphere's center and radius once and writes its
answer once: an 8-byte count, or the returned [capacity, 2] int64 pair
buffer. The count depends only on the scene and the traffic, so a change
to the program's plans, culls or kernels leaves it where it is.
"""


def frame_bytes(n, itemsize, capacity):
    """Bytes a frame must move at the least."""
    answer = 16 * capacity if capacity else 8
    return 4 * n * itemsize + answer
