"""Seconds from the harness's start to the window's: imports, the CUDA
context, the kernel library's build or load, the frames, and one warm-up
call a frame."""


def read(ctx):
    return ctx.setup_s
