"""Mean host time from the call into the entry until it returns, before
the frame's count is read and the device synchronized, over the window's
frames, ms. It holds the host syncs the entry makes itself."""


def read(ctx):
    return sum(ctx.enqueue_s) / len(ctx.enqueue_s) * 1e3
