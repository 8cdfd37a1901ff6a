"""Times variants of the grid emission and the diagonal count kernels.

``grid_emit_kernel`` (``csrc/grid.cu``) gives each entry (a tile) a
warp, four a block, and walks the tile in one pass, an a row a step; it
ranks and writes the row's hits only when a lane hit (a warp vote),
stops the fill's entries at the next entry's base and culls neighbour
tiles by union boxes. This script builds grid.cu nine times: as it is
("warp"), two a rows a step where the b cell has one chunk, one vote
for both ("two_rows"), one wave of the blocks the card
holds with the warps striding over the entries ("one_wave"), with
branches that skip a culled group and a self tile's groups below the row
("skips"; as it is, every group is tested and masked), at most 85
registers a thread, for six blocks an SM ("min6"), without the
stop ("no_stop": every entry walks its whole tile), without the cull
("no_cull"), without the vote ("no_gate": every group of every row
ranked by ballot and __popc), and with the port's earlier kernel in its
place ("block": one 128-thread block a tile, a count pass, a block scan
and a write pass). It times them on the 1M grid fill's inputs at
capacity 16384 (its own 16384 entries with the hit count, and the hit
tiles alone) and on the dense oracle scene's grid (65,536 spheres,
grid_dim 8, cell_capacity 192, room for every pair), each launch held
to ``emit_pairs_plain`` bit for bit.

``diag_count_kernel`` (``csrc/slab_sweep.cu``) gives each thread DIAG_K
consecutive positions, tests each staged partner column against all of
them by the sign bits of float differences, and skips a column for the
warp on two votes: where its zlo is at or past the highest zhi of each
thread's boxes, then where it meets no box in y; its staging keeps a
column group's seven channel loads in flight together. This script
builds slab_sweep.cu with DIAG_K 4, 8 ("k8", as it is) and 16, with six
float compares in place of the sign bits ("k8_compare"), without the
zlo vote ("k8_no_gate"), without the y vote ("k8_no_ygate"), with the
staging's loads one channel at a time
("k8_serial_loads"), and with the port's earlier kernel ("one": a
position a thread, six shared loads a test), and times them on the 1M
slab plan at d_max 0, 16, 48 and 130, each launch held to
``diag_count_plain``. ptxas' registers and spills of each build are
printed first.

Variants run in turns (a, b, .., b, a, twice). Prints one JSON line a
case: the median queued ms (20 calls in a row, 10 samples) of each run,
by variant. Run on a card from the root of the repo:
``PYTHONPATH=. python3 emit_diag_variants.py``. Builds into
``build/emit_diag_variants/``.
"""
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from collision_tpu_torch import grid, slabs
from collision_tpu_torch.kernels import emit, slab_sweep

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "collision_tpu_torch" / "csrc"
OUT = ROOT / "build" / "emit_diag_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"grid_emit_launch": [P, I, I, I, P, P, L, P, L, P, P],
            "diag_count_launch": [P, P, L, I, P, P]}

# The port's earlier emission: a 128-thread block a tile, two passes.
BLOCK_KERNEL = """constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// 1 + the index of the cell's last live row (0 when it has none), by a
// block-wide atomicMax into *occ, which the caller zeroed.
__device__ __forceinline__ void cell_occupancy(const float4* __restrict__ cell,
                                               int M, int* occ) {
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    if (live(cell[2 * i].x)) atomicMax(occ, i + 1);
}

// The lane's rows b0 + 32g + lane (g < BREG) of a b cell, dead past M.
// Returns the number of 32-row groups up to the chunk's last live row,
// the same in every lane of the warp.
__device__ __forceinline__ int load_b(const float4* __restrict__ cell, int M,
                                      int b0, Row (&b)[BREG]) {
  const int lane = threadIdx.x & 31;
  int groups = 0;
#pragma unroll
  for (int g = 0; g < BREG; ++g) {
    const int j = b0 + 32 * g + lane;
    b[g] = j < M ? load_row(cell, j) : dead_row();
    if (__ballot_sync(FULL, live(b[g].lo[0]))) groups = g + 1;
  }
  return groups;
}


// Block = entry e: tile tiles[e], first slot bases[e]; an entry whose base
// is at or past capacity writes nothing.
__global__ void __launch_bounds__(THREADS)
grid_emit_kernel(const float4* __restrict__ bins, int gd, int M, int tile_pad,
                 const long long* __restrict__ tiles,
                 const long long* __restrict__ bases, long long,
                 const long long* __restrict__, long long capacity,
                 int2* __restrict__ pairs) {
  const long long e = blockIdx.x;
  const long long base = bases[e];
  const long long t = tiles[e];
  const long long col = t / tile_pad;
  const int zo = static_cast<int>(t % tile_pad);
  if (base >= capacity || t < 0 || col >= static_cast<long long>(gd) * gd ||
      zo >= 14 * gd)
    return;
  const int z = zo / 14, o = zo % 14;
  const int x = static_cast<int>(col / gd), y = static_cast<int>(col % gd);
  const Offset d = tile_offset(o);
  const int gp = gd + 2;
  const float4* ac = cell_rows(bins, gp, M, x + 1, y + 1, z + 1);
  const float4* bc = cell_rows(bins, gp, M, x + 1 + d.dx, y + 1 + d.dy,
                               z + 1 + d.dz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;

  __shared__ int amax;
  __shared__ int row_off[BCHUNK];   // a row's hits, then its next slot
  if (threadIdx.x == 0) amax = 0;
  __syncthreads();
  cell_occupancy(ac, M, &amax);
  __syncthreads();
  const int na = amax;

  long long carry = base;   // the same in every thread
  for (int a0 = 0; a0 < na && carry < capacity; a0 += BCHUNK) {
    const int rows = min(BCHUNK, na - a0);
    row_off[threadIdx.x] = 0;
    __syncthreads();
    // Pass 1: the hits of each a row of the chunk.
    for (int b0 = 0; b0 < M; b0 += BCHUNK) {
      Row b[BREG];
      const int groups = load_b(bc, M, b0, b);
      if (groups == 0) continue;
      for (int r = warp; r < rows; r += WARPS) {
        const int i = a0 + r;
        const Row a = load_row(ac, i);
        int c = 0;
#pragma unroll
        for (int g = 0; g < BREG; ++g)
          if (g < groups)
            c += __popc(__ballot_sync(
                FULL, overlaps(a, b[g]) & (o != 0 || b0 + 32 * g + lane > i)));
        if (lane == 0) row_off[r] += c;
      }
    }
    __syncthreads();
    int chunk_hits;
    const int off = scan::block_exclusive_scan(row_off[threadIdx.x],
                                               &chunk_hits);
    row_off[threadIdx.x] = off;
    __syncthreads();
    // Pass 2: each hit at its slot, row-major.
    for (int b0 = 0; b0 < M; b0 += BCHUNK) {
      Row b[BREG];
      const int groups = load_b(bc, M, b0, b);
      if (groups == 0) continue;
      for (int r = warp; r < rows; r += WARPS) {
        long long slot = carry + row_off[r];
        if (slot >= capacity) continue;
        const int i = a0 + r;
        const Row a = load_row(ac, i);
#pragma unroll
        for (int g = 0; g < BREG; ++g) {
          if (g < groups) {
            const bool hit =
                overlaps(a, b[g]) & (o != 0 || b0 + 32 * g + lane > i);
            const unsigned m = __ballot_sync(FULL, hit);
            const long long s = slot + __popc(m & below);
            if (hit && s < capacity) pairs[s] = make_int2(a.id, b[g].id);
            slot += __popc(m);
          }
        }
        if (lane == 0) row_off[r] = static_cast<int>(slot - carry);
        __syncwarp();
      }
    }
    carry += chunk_hits;
    __syncthreads();   // row_off is reset for the next chunk
  }
}

"""

# The port's earlier diagonal count: a position a thread.
ONE_DIAG = """constexpr int DIAG_THREADS = 256;

// Block x takes positions p0 = x * DIAG_THREADS .. p0 + DIAG_THREADS - 1.
// Partner p + d (1 <= d <= d_max) of thread t sits at column t + d - 1 of
// the staged [6][DIAG_THREADS + d_max] boxes (positions p0 + 1 on).
__global__ void __launch_bounds__(DIAG_THREADS)
diag_count_kernel(const float* __restrict__ s, const float* __restrict__ thr,
                  int d_max, unsigned long long* __restrict__ total,
                  unsigned long long* __restrict__ flagged) {
  extern __shared__ float sb[];
  const int w = DIAG_THREADS + d_max;
  const int t = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * DIAG_THREADS;
  for (int idx = t; idx < 6 * w; idx += DIAG_THREADS)
    sb[idx] = stream::comp(s, p0 + 1 + idx % w, idx / w);

  const long long p = p0 + t;
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = stream::comp(s, p, c);
    hi[c] = stream::comp(s, p, c + 3);
  }
  __syncthreads();

  int hits = 0;
  for (int col = t; col < t + d_max; ++col)
    hits += (hi[0] > sb[col]) & (lo[0] < sb[3 * w + col]) &
            (hi[1] > sb[w + col]) & (lo[1] < sb[4 * w + col]) &
            (hi[2] > sb[2 * w + col]) & (lo[2] < sb[5 * w + col]);
  // Missed-pair detector at distance d_max + 1: same slab (channel 7, a
  // float compare as in the TPU kernel) and z within thr. Pads are +inf
  // in every channel, so "inf < inf + thr" never flags them.
  const long long q = p + d_max + 1;
  const float zhi_thr = hi[2] + thr[0];
  int flag = (stream::comp(s, q, 7) == stream::comp(s, p, 7)) &
             (stream::comp(s, q, 2) < zhi_thr);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, o);
    flag += __shfl_down_sync(0xffffffffu, flag, o);
  }
  __shared__ int warp_sums[2][DIAG_THREADS / 32];
  if ((t & 31) == 0) {
    warp_sums[0][t >> 5] = hits;
    warp_sums[1][t >> 5] = flag;
  }
  __syncthreads();
  if (t == 0) {
    int h = 0, f = 0;
#pragma unroll
    for (int i = 0; i < DIAG_THREADS / 32; ++i) {
      h += warp_sums[0][i];
      f += warp_sums[1][i];
    }
    if (h) atomicAdd(total, static_cast<unsigned long long>(h));
    if (f) atomicAdd(flagged, static_cast<unsigned long long>(f));
  }
}

"""

SIGN_TEST = """  return column::less(lo, a.hi[x][k]) & column::less(a.lo[x][k], hi);"""
COMPARE_TEST = """  return (a.hi[x][k] > lo) & (a.lo[x][k] < hi) ? 0x80000000u : 0u;"""
EMIT_GATE = "            if (__any_sync(FULL, any))\n"
LAUNCH_BOUNDS = "__launch_bounds__(32 * EMIT_WARPS)"
WALK = "        while (am && slot < end) {"
# The group tests with branches that skip a culled group and, on a self
# tile, a group below the row.
MASKED_GROUPS = """              const int j = q * BCHUNK + 32 * g + lane;
              hit[g] = (keep >> g & 1u) & overlaps(a, b[g]) &
                       (!self | (j > i));"""
SKIPPED_GROUPS = """              const int j0 = q * BCHUNK + 32 * g;
              hit[g] = false;
              if ((keep >> g & 1u) && !(self && j0 + 31 <= i))
                hit[g] = overlaps(a, b[g]) & (!self || j0 + lane > i);"""
# The walk two a rows a step where the b cell has one chunk: one vote for
# both rows' tests, their hits ranked row after row.
TWO_ROWS = """        while (am && slot < end) {
          // Rows r0 and, with one b chunk, the next live row r1 (-1: none):
          // their hits are ranked in that order, row-major.
          const int r0 = 32 * k + __ffs(am) - 1;
          am &= am - 1;
          int r1 = -1;
          if (nbq == 1 && am) {
            r1 = 32 * k + __ffs(am) - 1;
            am &= am - 1;
          }
          const int i0 = p * BCHUNK + r0, i1 = p * BCHUNK + r1;
          const Row a0 = load_row(sa, r0);
          const Row a1 = load_row(sa, r1 < 0 ? r0 : r1);
          for (int q = self ? i0 / BCHUNK : 0; q < nbq && slot < end; ++q) {
            if (q != bq) {
              load_chunk(bc, M, q, b);
              bq = q;
            }
            if (kp != p || kq != q) {
              keep = 0;
#pragma unroll
              for (int g = 0; g < BREG; ++g)
                if (__ballot_sync(FULL, by_union ? cull::meets(b[g], ua)
                                                 : live(b[g].lo[0])))
                  keep |= 1u << g;
              kp = p;
              kq = q;
            }
            // Test the rows against every group of the chunk, without
            // branches (masks, not skips); rank and write only when some
            // lane hit (most rows hit nothing).
            bool h0[BREG], h1[BREG];
            bool any = false;
#pragma unroll
            for (int g = 0; g < BREG; ++g) {
              const int j = q * BCHUNK + 32 * g + lane;
              const bool kept = keep >> g & 1u;
              h0[g] = kept & overlaps(a0, b[g]) & (!self | (j > i0));
              h1[g] = kept & (r1 >= 0) & overlaps(a1, b[g]) &
                      (!self | (j > i1));
              any |= h0[g] | h1[g];
            }
            if (__any_sync(FULL, any)) {
              rank_and_write(h0, a0.id, b, below, capacity, pairs, slot);
              rank_and_write(h1, a1.id, b, below, capacity, pairs, slot);
            }
          }
        }
      }
    }
  }
}

}  // namespace

"""


DIAG_GATE = ("  if (!__any_sync(0xffffffffu, column::less(zlo, zmax) >> 31)) "
             "return 0;\n")
WAVE = "std::min((h + EMIT_WARPS - 1) / EMIT_WARPS, EMIT_MAX_BLOCKS)"
# One wave of the blocks the card holds at once, the warps striding over
# the entries.
ONE_WAVE = """[&] {
          int dev = 0, sms = 0, per = 0;
          cudaGetDevice(&dev);
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per, grid_emit_kernel, 32 * EMIT_WARPS, 0);
          return std::min((h + EMIT_WARPS - 1) / EMIT_WARPS,
                          static_cast<long long>(std::max(1, sms * per)));
        }()"""
# The diagonal count's staging a channel at a time: one 16-byte load in
# flight a thread.
STAGE_BATCHED = """    float4 v[DIAG_CHANNELS];
#pragma unroll
    for (int ch = 0; ch < DIAG_CHANNELS; ++ch)
      v[ch] = *reinterpret_cast<const float4*>(row + (ch < 6 ? ch : 7) * LANE);
    float* at = sb + diag_col(c);
#pragma unroll
    for (int ch = 0; ch < DIAG_CHANNELS; ++ch) {
      const float e[4] = {v[ch].x, v[ch].y, v[ch].z, v[ch].w};"""
STAGE_SERIAL = """    float* at = sb + diag_col(c);
#pragma unroll 1
    for (int ch = 0; ch < DIAG_CHANNELS; ++ch) {
      const float4 x = *reinterpret_cast<const float4*>(
          row + (ch < 6 ? ch : 7) * LANE);
      const float e[4] = {x.x, x.y, x.z, x.w};"""
# The diagonal count without its y vote: x, y and z of every box of a
# column that passes the zlo vote.
Y_GATE = """  if (!__any_sync(0xffffffffu, any >> 31)) return 0;
  const float xlo"""


def replace(text, old, new, what):
    if old not in text:
        raise SystemExit(f"{what} no longer holds {old!r}")
    return text.replace(old, new)


def emit_sources():
    """{variant: grid.cu text}."""
    src = (SRC / "grid.cu").read_text()
    first = src.index("// Warp = entry e")
    last = src.index("}  // namespace")
    block = replace(src[:first] + BLOCK_KERNEL + src[last:],
                    '#include "cull.cuh"',
                    '#include "block_scan.cuh"\n#include "cull.cuh"', "grid.cu")
    block = replace(block, WAVE, "h", "grid.cu")
    return {
        "warp": src,
        "two_rows": (src[:src.index(WALK)] + TWO_ROWS
                     + src[src.index("// The grid count of padded bins"):]),
        "one_wave": replace(src, WAVE, ONE_WAVE, "grid.cu"),
        "skips": replace(src, MASKED_GROUPS, SKIPPED_GROUPS, "grid.cu"),
        "min6": replace(src, LAUNCH_BOUNDS, LAUNCH_BOUNDS[:-1] + ", 6)",
                        "grid.cu"),
        "no_stop": replace(src, "n_hit && e + 1 < entries ? min(capacity, "
                           "bases[e + 1]) : capacity", "capacity", "grid.cu"),
        "no_cull": replace(src, "const bool by_union = !self;",
                           "const bool by_union = false;", "grid.cu"),
        "no_gate": replace(src, EMIT_GATE, "", "grid.cu"),
        "block": block}


def diag_sources():
    """{variant: slab_sweep.cu text}."""
    src = (SRC / "slab_sweep.cu").read_text()
    out = {}
    for k in (4, 8, 16):
        kk = replace(src, "constexpr int DIAG_K = 8;",
                     f"constexpr int DIAG_K = {k};", "slab_sweep.cu")
        out[f"k{k}"] = replace(kk, SIGN_TEST, SIGN_TEST, "slab_sweep.cu")
    out["k8_compare"] = replace(src, SIGN_TEST, COMPARE_TEST, "slab_sweep.cu")
    out["k8_no_gate"] = replace(src, DIAG_GATE, "", "slab_sweep.cu")
    out["k8_serial_loads"] = replace(src, STAGE_BATCHED, STAGE_SERIAL,
                                     "slab_sweep.cu")
    out["k8_no_ygate"] = replace(src, Y_GATE, "  const float xlo",
                                 "slab_sweep.cu")
    first = src.index("constexpr int DIAG_THREADS = 128;")
    last = src.index("}  // namespace")
    one = src[:first] + ONE_DIAG + src[last:]
    one = replace(one, "positions % DIAG_SPAN", "positions % DIAG_THREADS",
                  "slab_sweep.cu")
    one = replace(one, "sizeof(float) * DIAG_CHANNELS * diag_stride(d_max)",
                  "sizeof(float) * 6 * (DIAG_THREADS + d_max)",
                  "slab_sweep.cu")
    out["one"] = replace(one, "positions / DIAG_SPAN",
                         "positions / DIAG_THREADS", "slab_sweep.cu")
    return out


def build(source, variants, entry, kernel):
    """{name: entry point} of ``source`` built once a variant (its text),
    nvcc run in parallel; prints ``kernel``'s ptxas line of each."""
    procs = {}
    for name, text in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in SRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / source).write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
             "-o", str(d / "lib.so"), str(d / source)],
            stderr=subprocess.PIPE, text=True)
    launches = {}
    for name, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise SystemExit(f"nvcc {name}: {err[-3000:]}")
        lines = err.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and kernel in line)
        print(json.dumps({"build": name, "kernel": kernel, "ptxas": [
            re.sub(r"^ptxas info\s*: ", "", x).strip()
            for x in lines[at + 2:at + 4]]}), flush=True)
        fn = getattr(ctypes.CDLL(str(OUT / name / "lib.so")), entry)
        fn.argtypes = ARGTYPES[entry]
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


def run(label, launches, order, make_out, args, same):
    """Times each variant's launch in ``order``, checking its output
    (``make_out()``, filled by the launch) with ``same``; prints the
    case's JSON line and exits non-zero if a variant differs."""
    st = torch.cuda.current_stream().cuda_stream
    times, equal = {}, True
    for name in order:
        out = make_out()
        full = (*args, out.data_ptr(), st)
        if launches[name](*full):
            raise SystemExit(f"{name}: launch refused")
        torch.cuda.synchronize()
        equal &= same(out)
        times.setdefault(name, []).append(
            queued_ms(lambda: launches[name](*full)))
    print(json.dumps({"case": label, "equal": equal,
                      **{f"{k}_ms": v for k, v in times.items()}}),
          flush=True)
    if not equal:
        sys.exit(f"{label}: a variant differs from its plain version")


def emit_cases(dev):
    """(label, bins, gd, mc, capacity, fill) of the emission's cases."""
    _, _, c, r = cs.uniform_scene(cs.N, dev)
    gd, mc = cs.GRID_CONFIG
    bins = grid.build_grid(c, r, gd, mc)[0]
    yield "grid_fill_1m", bins, gd, mc, cs.CAPACITY, True
    yield "grid_hits_1m", bins, gd, mc, cs.CAPACITY, False
    _, _, c, r = cs.uniform_scene(cs.ORACLE_N, dev, cs.DENSE_R)
    gd, mc = cs.DENSE_GRID
    bins = grid.build_grid(c, r, gd, mc)[0]
    total = int(emit.halo_tile_counts(bins, gd, mc).sum())
    yield "dense_grid", bins, gd, mc, total + 64, True


def main():
    if not torch.cuda.is_available():
        sys.exit("emit_diag_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    em = build("grid.cu", emit_sources(), "grid_emit_launch",
               "grid_emit_kernel")
    dg = build("slab_sweep.cu", diag_sources(), "diag_count_launch",
               "diag_count_kernel")
    dev = torch.device("cuda")
    for label, bins, gd, mc, capacity, fill in emit_cases(dev):
        tc = emit.halo_tile_counts(bins, gd, mc).reshape(-1)
        tiles = torch.nonzero(tc).flatten()
        bases = (torch.cumsum(tc, 0) - tc)[tiles]
        n_hit = None
        if fill:
            tiles, bases, n_hit = emit.fill_entries(tc, capacity)
        want = emit.emit_pairs_plain(bins, tiles, bases, gd, mc, capacity,
                                     n_hit=n_hit)
        order = list(em)
        run(label, em, (order + order[::-1]) * 2,
            lambda: torch.full((capacity, 2), -1, dtype=torch.int32,
                               device=dev),
            (bins.data_ptr(), gd, mc, emit.tile_pad(gd), tiles.data_ptr(),
             bases.data_ptr(), tiles.numel(),
             None if n_hit is None else n_hit.data_ptr(), capacity),
            lambda out: torch.equal(out.view(torch.uint32).long(), want))
    _, _, c, r = cs.uniform_scene(cs.N, dev)
    plan = slabs.plan_slabs(c, r, *slabs.default_slab_config(cs.N))
    names = list(dg)
    for d_max in (0, 16, cs.DIAG_D_MAX, 130):
        want = [int(x) for x in slab_sweep.diag_count_plain(
            plan.stream, plan.diag_thr, d_max)]
        run(f"diag_1m_d{d_max}", dg, (names + names[::-1]) * 2,
            lambda: torch.zeros((2,), dtype=torch.int64, device=dev),
            (plan.stream.data_ptr(), plan.diag_thr.data_ptr(),
             slab_sweep._diag_positions(plan.stream, d_max), d_max),
            lambda out: out.tolist() == want)


if __name__ == "__main__":
    main()
