"""Times column_masks_kernel's overlap test against plain float compares.

``csrc/column_tile.cuh`` tests a box pair by the sign bits of six float
differences. This script builds ``csrc/sweep.cu`` twice with nvcc, as it
is and with six compares in place of that test in the header (the rest
the same), and times
both on the dense exact plan (rpw 12), the 1M column plan (rpw 2) and
the power-law parked plan (rpw 3) of ``chip_smoke.py``, in turns (sign,
compare, compare, sign, twice), each launch checked against
``sweep_masks_plain`` with ``torch.equal``. Prints one JSON line a plan:
the median queued ms of each run, by variant.

Run on a card from the root of the repo: ``PYTHONPATH=. python3
masks_variants.py``. Builds into ``build/masks_variants/``.
"""
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from collision_tpu_torch import columns, hetero
from collision_tpu_torch.kernels import sweep

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "collision_tpu_torch" / "csrc"
OUT = ROOT / "build" / "masks_variants"
NVCC = "/usr/local/cuda/bin/nvcc"

COMPARE_TEST = """// True iff a-row (a, c) = (lo, hi) overlaps lane i.
__device__ __forceinline__ bool overlap(const float4& a, const float4& c,
                                        const float (&lo)[3][LPT],
                                        const float (&hi)[3][LPT], int i) {
  return (lo[0][i] < c.x) & (a.x < hi[0][i]) & (lo[1][i] < c.y) &
         (a.y < hi[1][i]) & (lo[2][i] < c.z) & (a.z < hi[2][i]);
}

"""

# (sign-bit form, compare form): the -0 fix-ups go, and a hit is a bool.
EDITS = (
    ("tile::stream_comp(s, g0 + r, c) + 0.0f", "tile::stream_comp(s, g0 + r, c)"),
    ("tile::stream_comp(s, g0 + r, c + 3) + 0.0f",
     "tile::stream_comp(s, g0 + r, c + 3)"),
    ("t.lo[c][0] = l.x + 0.0f;", "t.lo[c][0] = l.x;"),
    ("t.lo[c][1] = l.y + 0.0f;", "t.lo[c][1] = l.y;"),
    ("t.hi[c][0] = h.x + 0.0f;", "t.hi[c][0] = h.x;"),
    ("t.hi[c][1] = h.y + 0.0f;", "t.hi[c][1] = h.y;"),
    ("word[i] = __funnelshift_l(overlap(a, c, t.lo, t.hi, i), word[i], 1);",
     "word[i] = (word[i] << 1) | overlap(a, c, t.lo, t.hi, i);"),
    ("word[i] |= (overlap(a, c, t.lo, t.hi, i) & 0x80000000u) >> (31 - r);",
     "word[i] |= static_cast<uint32_t>(overlap(a, c, t.lo, t.hi, i)) << r;"),
)


def replace(text, old, new):
    if old not in text:
        raise SystemExit(f"column_tile.cuh no longer holds {old!r}")
    return text.replace(old, new)


def compare_source(src):
    """column_tile.cuh with six compares in place of the sign-bit test."""
    first = src.index("// The sign bit of x - y")
    last = src.index("// Run by threads 0 .. CHUNK-1")
    out = src[:first] + COMPARE_TEST + src[last:]
    for old, new in EDITS:
        out = replace(out, old, new)
    return out


def build(variants):
    """{name: sweep_masks_launch} of sweep.cu on each text of
    column_tile.cuh, nvcc run in parallel."""
    procs = {}
    for name, text in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in SRC.glob("*.cuh"):
            shutil.copy(h, d)
        shutil.copy(SRC / "sweep.cu", d)
        (d / "column_tile.cuh").write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
             str(d / "sweep.cu")], stderr=subprocess.PIPE, text=True)
    launches = {}
    for name, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise SystemExit(f"nvcc {name}: {err[-2000:]}")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).sweep_masks_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        launches[name] = fn
    return launches


def queued_ms(fn, batch=20, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / batch)
    return statistics.median(ms)


def plans(dev):
    _, _, c, r = cs.uniform_scene(cs.DENSE_N, dev, cs.DENSE_R)
    yield "dense", columns.plan_columns(c, r, 14, 4608, 295), 12
    _, _, c, r = cs.uniform_scene(cs.N, dev)
    yield "1M", columns.plan_columns(
        c, r, *columns.default_column_config(cs.N)), 2
    _, _, c, r = cs.powerlaw_scene(cs.N, dev)
    _, _, parked, _ = hetero._split(c, r, None)
    yield "powerlaw", columns.plan_columns(c, parked, 26, 1728, 313), 3


def main():
    if not torch.cuda.is_available():
        sys.exit("masks_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = (SRC / "column_tile.cuh").read_text()
    launches = build({"sign": src, "compare": compare_source(src)})
    order = ["sign", "compare", "compare", "sign"] * 2
    dev = torch.device("cuda")
    st = torch.cuda.current_stream().cuda_stream
    for label, plan, rpw in plans(dev):
        ncols, mc = plan.gxy ** 2, plan.mc
        kg, ng = sweep.mask_groups(mc, rpw)
        want = sweep.sweep_masks_plain(plan, rpw)
        times, equal = {}, True
        for name in order:
            out = torch.full((ncols * ng, kg * 5 * rpw * 2, 128), 7,
                             dtype=torch.int32, device=dev)
            args = (plan.stream.data_ptr(), plan.starts.data_ptr(),
                    plan.w0.data_ptr(), plan.wcap.data_ptr(), ncols, mc, rpw,
                    kg, ng, out.data_ptr(), st)
            if launches[name](*args):
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            equal &= torch.equal(out, want)
            times.setdefault(name, []).append(
                queued_ms(lambda: launches[name](*args)))
            del out
        print(json.dumps({"plan": label, "rpw": rpw, "equal": equal,
                          **{f"{k}_ms": v for k, v in times.items()}}),
              flush=True)
        if not equal:
            sys.exit(f"{label}: a variant differs from sweep_masks_plain")


if __name__ == "__main__":
    main()
