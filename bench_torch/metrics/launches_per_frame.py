"""Launches of the program's hand-written kernels (its ``LAUNCHES``
counter) over the window, per frame."""


def read(ctx):
    return sum(ctx.launches.values()) / ctx.frames
