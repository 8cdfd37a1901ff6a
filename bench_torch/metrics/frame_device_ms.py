"""Device busy ms per frame of the profiled stretch after the window:
the union of the frame's kernel, memset and memcpy intervals, the card
time a frame takes whatever the host does around it."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return tr.busy_s / tr.frames * 1e3
