"""Device ms per traced frame of the events named in ``kernels.txt``:
the program's hand-written kernels."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    secs = sum(e["dur"] for e in tr.device if tr.is_kernel(e)) / 1e6
    return secs / tr.frames * 1e3
