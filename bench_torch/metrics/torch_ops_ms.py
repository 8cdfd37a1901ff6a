"""Device ms per traced frame of every device event that is not one of
the program's hand-written kernels: sorts, scans, gathers, copies,
memsets and the pair buffer's stack."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    secs = sum(e["dur"] for e in tr.device if not tr.is_kernel(e)) / 1e6
    return secs / tr.frames * 1e3
