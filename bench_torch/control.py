"""The readings that the check's limits are set from, on the card.

    python3 bench_torch/control.py --workload NAME --seeds S1 S2 ... \
        --control-seeds C1 C2 C3 --seconds S

from the root of a checkout. For each ``--seeds`` seed it runs the cell
as the benchmark does, with a window of ``--seconds``, and for each
``--control-seeds`` seed it runs the cell with the control in the
program's place: the configuration's plain reference computed in the
precision below the scene's (bfloat16 for float32, float32 for float64).
Each run prints one JSON line with its compared numbers. The benchmark's
own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

import digest  # noqa: E402
import entries  # noqa: E402
import harness  # noqa: E402
import scenes  # noqa: E402


def control_frame(config, traffic, device):
    """A frame function that answers as the plain reference does, in the
    precision below the configuration's, with the entry's shape of
    answer."""
    ref = harness.load_module(HERE / "references"
                              / f"{config['reference']}.py")
    low = ref.LOWER[scenes.DTYPES[config["dtype"]]]
    capacity = int(traffic["capacity"])
    has_ok = traffic["entry"] != "Collider.get_collisions"

    def frame(coords, radii):
        ok = torch.ones((), dtype=torch.bool, device=device) if has_ok \
            else None
        if capacity == 0:
            count = ref.count(coords, radii, low)
            return entries.Answer(torch.tensor(count), None, ok)
        pairs = torch.full((capacity, 2), digest.NO_PAIR, dtype=torch.int64,
                           device=device)
        k = 0
        for a, b in ref.pairs(coords, radii, low):
            m = max(0, min(a.numel(), capacity - k))
            pairs[k:k + m, 0] = a[:m]
            pairs[k:k + m, 1] = b[:m]
            k += a.numel()
        return entries.Answer(torch.tensor(k), pairs, ok)
    return frame


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload, config, traffic = harness.cell(bench, args.workload, ROOT)
    device = torch.device("cuda", 0)
    runs = [("program", s) for s in args.seeds]
    runs += [("control", s) for s in args.control_seeds]
    for kind, seed in runs:
        t0 = time.perf_counter()
        fn = control_frame(config, traffic, device) if kind == "control" \
            else None
        ctx = harness.measure(config, traffic, seed, args.seconds, device,
                              t0, frame_fn=fn)
        print(json.dumps({
            "workload": args.workload, "run": kind, "seed": seed,
            "checks": ctx.checks, "frames": ctx.frames,
            "attempted": ctx.attempted, "failed": ctx.failed,
            "pair_buffers_checked": ctx.pairs_checked,
            "frame_ms": ctx.window_s / ctx.frames * 1e3,
            "setup_s": ctx.setup_s, "check_s": ctx.check_s,
            "card": torch.cuda.get_device_name(device),
            "power_limit": harness.power_limit(device)}), flush=True)
        del fn, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
