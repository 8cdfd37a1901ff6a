"""1 - busy / wall, %: busy is the device's union of event intervals per
traced frame, wall the unprofiled window's time per frame in the same
process."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    busy = tr.busy_s / tr.frames
    wall = ctx.window_s / ctx.frames
    return (1 - busy / wall) * 100
