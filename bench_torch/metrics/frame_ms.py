"""Wall time of the window over the frames completed in it, ms."""


def read(ctx):
    return ctx.window_s / ctx.frames * 1e3
