"""Device events (kernel, memset, memcpy) per traced frame."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return len(tr.device) / tr.frames
