"""Run one benchmark cell of the PyTorch and CUDA port on this machine's
card(s).

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number beside its limit, which also close standard error. Exits 2,
printing no result, when there is no CUDA device or fewer than the cell
asks for; the port is never run on the CPU here.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # Kernel caches at fixed paths inside the checkout (the port builds
    # its own library into build/collision_tpu_torch/).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)
    import torch

    sys.path.insert(0, str(ROOT))
    import harness

    workload, config, traffic = harness.cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)

    ctx = harness.measure(config, traffic, args.seed, args.seconds, device,
                          T_START, traced=bool(args.trace))
    out = harness.result(bench, workload, ctx, bool(args.trace))
    tr = ctx.trace
    if tr is not None:
        kernel_events = sum(1 for e in tr.device if tr.is_kernel(e))
        if kernel_events < tr.launches:
            print(f"trace dropped device events: {kernel_events} "
                  f"hand-written kernel events for {tr.launches} launches",
                  file=sys.stderr)
    for fault in ctx.faults[:20]:
        print("fault " + fault, file=sys.stderr)
    print(f"frames {ctx.frames} in {ctx.window_s:.3f} s, pair buffers "
          f"checked {ctx.pairs_checked}, check {ctx.check_s:.1f} s, card "
          f"{out['device']['kind']}, {out['device'].get('power_limit')}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
