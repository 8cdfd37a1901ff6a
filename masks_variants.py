"""Times variants of the masks kernels: column_masks_kernel's overlap
test against plain float compares, and slab_masks_kernel's lane loads
and walk.

``csrc/column_tile.cuh`` tests a box pair by the sign bits of six float
differences. This script builds ``csrc/sweep.cu`` twice with nvcc, as it
is ("sign") and with six compares in place of that test in the header
("compare"), and times both on the dense exact plan (rpw 12), the 1M
column plan (rpw 2) and the power-law parked plan (rpw 3) of
``chip_smoke.py``.

``slab_masks_kernel`` writes each window row's words at rolled lanes,
word l at sorted position w + r*128 + l, and loads each lane on its own
(4 bytes a component). This script builds ``csrc/slab_sweep.cu`` three
times: as it is ("rolled"), with one 8-byte load a component for a
thread's two lanes where w is even ("pairs"), and with the slab count's
walk in its place ("segments": 64-lane segments from floor(w/64)*64,
each in one stream row, 8-byte lane loads, each word stored on its own
at its rolled position, the words past the window zeroed first), and
times them on the 1M slab plan (one row, windows clamped to 128 lanes,
as the slab fill runs it) and the giants route's parked slab plan (two
rows, 256 lanes).

Each plan's variants run in turns (a, b, .., b, a, twice), each launch
checked against ``sweep_masks_plain`` or ``slab_masks_plain`` with
``torch.equal``. Prints one JSON line a plan: the median queued ms of
each run, by variant.

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
from collision_tpu_torch import columns, hetero, slabs
from collision_tpu_torch.kernels import slab_sweep, sweep

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
    ("stream::comp(s, g0 + r, c) + 0.0f", "stream::comp(s, g0 + r, c)"),
    ("stream::comp(s, g0 + r, c + 3) + 0.0f",
     "stream::comp(s, g0 + r, c + 3)"),
    ("t.lo[c][0] = l.x + 0.0f;", "t.lo[c][0] = l.x;"),
    ("t.lo[c][1] = l.y + 0.0f;", "t.lo[c][1] = l.y;"),
    ("t.hi[c][0] = h.x + 0.0f;", "t.hi[c][0] = h.x;"),
    ("t.hi[c][1] = h.y + 0.0f;", "t.hi[c][1] = h.y;"),
    ("word[i] = __funnelshift_l(overlap(a, c, t.lo, t.hi, i), word[i], 1);",
     "word[i] = (word[i] << 1) | overlap(a, c, t.lo, t.hi, i);"),
    ("word[i] |= (overlap(a, c, t.lo, t.hi, i) & 0x80000000u) >> (31 - r);",
     "word[i] |= static_cast<uint32_t>(overlap(a, c, t.lo, t.hi, i)) << r;"),
)

# slab_masks_kernel with the slab count's walk: each window's lanes in
# segments that lie in one stream row, each word stored on its own.
SEGMENTS_KERNEL = """__global__ void __launch_bounds__(LANE)
slab_masks_kernel(const float* __restrict__ s, const int* __restrict__ starts,
                  const int* __restrict__ w0, const int* __restrict__ wcap,
                  int mc, int rpw, int kg, int ng, uint32_t* __restrict__ out) {
  const int b = blockIdx.y, kq = blockIdx.x;
  const int nrows = NOFF * rpw * 2;
  uint32_t* rows = out + ((static_cast<long long>(b) * ng + kq / kg) * kg
                          + kq % kg) * nrows * LANE;
  const int a1 = starts[b + 1];
  const int g0 = starts[b] + kq * CHUNK;
  const int alen = kq < mc ? max(0, min(a1 - g0, CHUNK)) : 0;
  if (alen == 0) {
    uint4* o = reinterpret_cast<uint4*>(rows);
    for (int i = threadIdx.x; i < nrows * LANE / 4; i += LANE)
      o[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  __shared__ float4 slo[CHUNK], shi[CHUNK];
  __shared__ cull::Box half_union[2];
  __shared__ int win[NOFF][3];   // each window's range [js, je), segments
  if (threadIdx.x < CHUNK) {
    column::stage_chunk(s, g0, alen, slo, shi, half_union);
  } else if (threadIdx.x < CHUNK + NOFF) {
    const int off = threadIdx.x - CHUNK;
    const long long e = (static_cast<long long>(b) * mc + kq) * NOFF + off;
    const int w = w0[e], je = w + min(wcap[e], rpw * LANE);
    win[off][0] = w;
    win[off][1] = je;
    win[off][2] = je > w ? (je + SEG - 1) / SEG - w / SEG : 0;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < NOFF * rpw * LANE; i += LANE) {
    const int off = i / (rpw * LANE), rel = i % (rpw * LANE);
    if (rel >= win[off][1] - win[off][0]) {   // past the window: zeros
      uint32_t* word = rows + (off * rpw + rel / LANE) * 2 * LANE
                       + rel % LANE;
      word[0] = 0u;
      word[LANE] = 0u;
    }
  }
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  const int units = win[0][2] + win[1][2];
  for (int unit = warp; unit < units; unit += LANE / 32) {
    const int off = unit < win[0][2] ? 0 : 1;
    const int seg = unit - (off ? win[0][2] : 0);
    const int js = win[off][0], je = win[off][1];
    const int j0 = (js / SEG + seg) * SEG + lt * LPT;
    cull::Box wu;
    const column::Lanes t = column::load_lanes(s, j0, js, je, &wu);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const float4* al = slo + h * 32;
      const float4* ah = shi + h * 32;
      const cull::Box hu = half_union[h];
      uint32_t word[LPT], keep[LPT];
      column::test_rows(al, ah,
                        column::survivors(al, ah, hu, wu, t, off == 0,
                                          j0 - g0 - 32 * h, keep),
                        t, word);
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        if (t.in[i]) {
          const int rel = j0 + i - js;
          rows[((off * rpw + rel / LANE) * 2 + h) * LANE + rel % LANE] =
              word[i] & keep[i];
        }
    }
  }
}

"""


def replace(text, old, new, what):
    if old not in text:
        raise SystemExit(f"{what} no longer holds {old!r}")
    return text.replace(old, new)


def compare_source(src):
    """column_tile.cuh with six compares in place of the sign-bit test."""
    first = src.index("// The sign bit of x - y")
    last = src.index("// Run by threads 0 .. CHUNK-1")
    out = src[:first] + COMPARE_TEST + src[last:]
    for old, new in EDITS:
        out = replace(out, old, new, "column_tile.cuh")
    return out


def pairs_source(src):
    """column_tile.cuh with 8-byte loads of a thread's two lanes in
    load_rolled_lanes where the pair starts at an even position."""
    old = "  load_apart(s, min(j0, je - 1), min(j0 + 1, je - 1), t);\n"
    return replace(src, old, "  if (j0 & 1)\n  " + old
                   + "  else\n    load_pair(s, min(j0, (je - 1) & ~1), t);\n",
                   "column_tile.cuh")


def segments_source(src):
    """slab_sweep.cu with the segment walk's masks kernel."""
    first = src.index("__global__ void __launch_bounds__(LANE)\n"
                      "slab_masks_kernel(")
    last = src.index("constexpr int DIAG_THREADS")
    return src[:first] + SEGMENTS_KERNEL + src[last:]


def build(source, variants, entry):
    """{name: entry point} of ``source`` (a csrc/*.cu file) built once a
    variant, each variant {file name: text} overriding sources, nvcc run
    in parallel."""
    procs = {}
    for name, files in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in list(SRC.glob("*.cuh")) + [SRC / source]:
            shutil.copy(f, d)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
             str(d / source)], stderr=subprocess.PIPE, text=True)
    launches = {}
    for name, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise SystemExit(f"nvcc {name}: {err[-2000:]}")
        fn = getattr(ctypes.CDLL(str(OUT / name / "lib.so")), entry)
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


def column_plans(dev):
    _, _, c, r = cs.uniform_scene(cs.DENSE_N, dev, cs.DENSE_R)
    yield "dense", columns.plan_columns(c, r, 14, 4608, 295), 12
    _, _, c, r = cs.uniform_scene(cs.N, dev)
    yield "1M", columns.plan_columns(
        c, r, *columns.default_column_config(cs.N)), 2
    _, _, c, r = cs.powerlaw_scene(cs.N, dev)
    _, _, parked, _ = hetero._split(c, r, None)
    yield "powerlaw", columns.plan_columns(c, parked, 26, 1728, 313), 3


def slab_plans(dev):
    """The slab plans, windows clamped to the rows as the fill runs them."""
    _, _, c, r = cs.uniform_scene(cs.N, dev)
    plan = slabs.plan_slabs(c, r, *slabs.default_slab_config(cs.N))
    yield "slab_1M", plan._replace(wcap=plan.wcap.clamp(max=128)), 1
    _, _, c, r = cs.giants_scene(cs.N, dev)
    _, _, parked, _ = hetero._split(c, r, None)
    plan = slabs.plan_slabs(c, parked, *slabs.default_slab_config(
        cs.N, gx=cs.HETERO_ROUTES["hetero_giants"][0][1]))
    yield "slab_giants", plan._replace(wcap=plan.wcap.clamp(max=256)), 2


def run(label, launches, order, shape, args, want):
    """Times each variant's launch in ``order`` on one plan, checking its
    buffer against ``want``; prints the plan's JSON line."""
    dev = want.device
    st = torch.cuda.current_stream().cuda_stream
    times, equal = {}, True
    for name in order:
        out = torch.full(shape, 7, dtype=torch.int32, device=dev)
        full = (*args, out.data_ptr(), st)
        if launches[name](*full):
            raise SystemExit(f"{name}: launch refused")
        torch.cuda.synchronize()
        equal &= torch.equal(out, want)
        times.setdefault(name, []).append(
            queued_ms(lambda: launches[name](*full)))
        del out
    print(json.dumps({"plan": label, "equal": equal,
                      **{f"{k}_ms": v for k, v in times.items()}}),
          flush=True)
    if not equal:
        sys.exit(f"{label}: a variant differs from its plain version")


def main():
    if not torch.cuda.is_available():
        sys.exit("masks_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tile = (SRC / "column_tile.cuh").read_text()
    col = build("sweep.cu", {"sign": {}, "compare": {
        "column_tile.cuh": compare_source(tile)}}, "sweep_masks_launch")
    slab = build("slab_sweep.cu", {
        "rolled": {},
        "pairs": {"column_tile.cuh": pairs_source(tile)},
        "segments": {"slab_sweep.cu": segments_source(
            (SRC / "slab_sweep.cu").read_text())}}, "slab_masks_launch")
    dev = torch.device("cuda")
    for label, plan, rpw in column_plans(dev):
        ncols, mc = plan.gxy ** 2, plan.mc
        kg, ng = sweep.mask_groups(mc, rpw)
        run(label, col, ["sign", "compare", "compare", "sign"] * 2,
            (ncols * ng, kg * 5 * rpw * 2, 128),
            (plan.stream.data_ptr(), plan.starts.data_ptr(),
             plan.w0.data_ptr(), plan.wcap.data_ptr(), ncols, mc, rpw, kg,
             ng), sweep.sweep_masks_plain(plan, rpw))
    for label, plan, rpw in slab_plans(dev):
        kg, ng = sweep.mask_groups(plan.mc, rpw)
        run(label, slab,
            ["rolled", "pairs", "segments", "segments", "pairs",
             "rolled"] * 2,
            (plan.gx * ng, kg * 2 * rpw * 2, 128),
            (plan.stream.data_ptr(), plan.starts.data_ptr(),
             plan.w0.data_ptr(), plan.wcap.data_ptr(), plan.gx, plan.mc,
             rpw, kg, ng),
            slab_sweep.slab_masks_plain(plan.stream, plan.starts, plan.w0,
                                        plan.wcap, rpw))


if __name__ == "__main__":
    main()
