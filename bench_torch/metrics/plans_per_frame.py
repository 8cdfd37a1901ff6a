"""Column plans built a frame, by an attempt or for the retry ladder's
statistics: the program's ``tracing.PLANS`` total over every frame the
program ran in this process (the set-up's warm-up call a frame, then the
window's and the traced stretch's frames). Read from the loaded program,
which this does not import; None where the program has no such
counter."""

import sys


def read(ctx):
    counter = getattr(sys.modules.get("collision_tpu_torch.tracing"),
                      "PLANS", None)
    if counter is None:
        return None
    return sum(counter.values()) / (ctx.traffic["frames"] + ctx.attempted)
