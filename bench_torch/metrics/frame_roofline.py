"""The frame's share of its roofline, %: the least time the card needs
for a frame's work (``work.frame_bytes`` at the published memory
bandwidth of ``peaks.json``) over the device's busy time per traced
frame."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0 or ctx.peaks is None:
        return None
    itemsize = 8 if ctx.config["dtype"] == "float64" else 4
    least = ctx.work.frame_bytes(ctx.n, itemsize, ctx.traffic["capacity"])
    least_s = least / ctx.peaks["hbm_bytes_per_s"]
    return least_s / (tr.busy_s / tr.frames) * 100
