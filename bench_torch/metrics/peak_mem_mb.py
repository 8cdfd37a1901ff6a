"""``torch.cuda.max_memory_allocated()`` over set-up, window and traced
stretch, in MB of 10^6 bytes; nothing on a run without a card."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e6
