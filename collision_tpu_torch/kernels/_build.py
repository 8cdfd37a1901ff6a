"""Build and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` (with the ``*.cuh`` headers they
include) into one shared library with a
plain C interface, on first use, into ``build/collision_tpu_torch/`` at
the root of the checkout; ``ctypes`` binds it. Nothing here runs at
import time, so the package imports on a machine with no CUDA toolkit.

Each C launch entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`launch` raises on a
non-zero code. Pointers and the stream go over as ``ctypes.c_void_p``.
``compact_tile()`` reports the compaction's tile size, so the wrapper
sizes its look-back state from the same constant the kernel uses.
"""

import ctypes
import functools
import subprocess
from pathlib import Path

import torch

from .. import tracing

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "collision_tpu_torch"
_LIB = _BUILD_DIR / "libcollision_kernels.so"

#: Kernel launches per wrapper: the port's counter, kept in ``tracing``.
LAUNCHES = tracing.LAUNCHES

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    # stream, starts, w0, wcap, gx, mc, rpw, first offset, dmin, total,
    # cuda stream
    "slab_count_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # stream, diag_thr, positions, d_max, out (count, flagged), cuda stream
    "diag_count_launch": [_P, _P, _L, _I, _P, _P],
    # stream, starts, w0, wcap, gx, mc, rpw, kg, ng, out, cuda stream
    "slab_masks_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # stream, starts, w0, wcap, ncols, mc, rpw, rolled, total, cuda stream
    "sweep_count_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # stream, starts, w0, wcap, ncols, mc, rpw, kg, ng, out, cuda stream
    "sweep_masks_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # mask, n, tiles, filling blocks, capacity, out, look-back state, its
    # status words, epochs, cuda stream
    "compact_launch": [_P, _L, _L, _I, _L, _P, _P, _L, ctypes.c_uint, _P],
    # mask elements per compaction tile
    "compact_tile": [],
    # bigs, c0, c1, n_always, stream, rows, counts, total, cuda stream
    "big_count_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P],
    # bigs, c0, c1, n_always, stream, rows, counts, bases, capacity, ida,
    # idb, cuda stream
    "big_emit_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P],
    # mask, wstart, cb, ids, nsort, row ends, rows, capacity, pairs,
    # cuda stream
    "pair_emit_launch": [_P, _P, _P, _P, _L, _P, _L, _L, _P, _P],
    # mask, rows, counts, cuda stream
    "row_popcount_launch": [_P, _L, _P, _P],
    # bins, gd, M, tile counts, tile_pad, total, cuda stream
    "grid_count_launch": [_P, _I, _I, _P, _I, _P, _P],
    # bins, gd, M, tile_pad, tiles, bases, h, hit count, capacity, pairs,
    # cuda stream
    "grid_emit_launch": [_P, _I, _I, _I, _P, _P, _L, _P, _L, _P, _P],
    # n, gd, f64, out bytes
    "grid_bins_workspace": [_L, _I, _I, _P],
    # coords, radii, n, gd, M, f64, workspace, its bytes, bins, ids, ok,
    # cuda stream
    "grid_bins_launch": [_P, _P, _L, _I, _I, _I, _P, _L, _P, _P, _P, _P],
    # n, gx, zbits, out bytes
    "slab_plan_workspace": [_L, _I, _I, _P],
    # coords, radii, n, gx, zbits, mc, col_capacity, slab_rows, stream
    # rows, workspace, its bytes, stream, starts, w0, wcap, maxima, ok,
    # diag_thr, cuda stream
    "slab_plan_launch": [_P, _P, _L, _I, _I, _I, _I, _I, _L, _P, _L, _P, _P,
                         _P, _P, _P, _P, _P, _P],
    # n, gxy, zbits, out bytes
    "column_plan_workspace": [_L, _I, _I, _P],
    # coords, radii, n, gxy, zbits, mc, col_capacity, slab_rows, stream
    # rows, workspace, its bytes, stream, starts, w0, wcap, stats, ok,
    # cuda stream
    "column_plan_launch": [_P, _P, _L, _I, _I, _I, _I, _I, _L, _P, _L, _P,
                           _P, _P, _P, _P, _P, _P],
}


def build():
    """Compile ``csrc/*.cu`` for sm_90a, one ``nvcc`` per source, all at
    once, and link them; returns ptxas' resource report."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    objs, procs = [], []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = _BUILD_DIR / (src.stem + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
             "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    report, failed = [], []
    for proc in procs:
        out, err = proc.communicate()
        report.append(err)
        if proc.returncode:
            failed.append(out + err)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = _LIB.with_suffix(".so.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    tmp.replace(_LIB)
    return "".join(report)


@functools.cache
def library():
    """The bound kernel library, built first if a source is newer."""
    newest = max(p.stat().st_mtime for p in _CSRC.glob("*.cu*"))
    if not _LIB.exists() or _LIB.stat().st_mtime < newest:
        build()
    lib = ctypes.CDLL(str(_LIB))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def current_stream(device_index):
    """The raw handle of a device's current CUDA stream, from PyTorch's
    own accessor: ``torch.cuda.current_stream`` builds a Stream object
    on every call, which costs more host time than some launches."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def launch(name, *args):
    """Call entry point ``name`` on the current CUDA stream; raise on a
    launch error."""
    launch_on(current_stream(torch.cuda.current_device()), name, *args)


def launch_on(stream, name, *args):
    """Call entry point ``name`` on the CUDA stream ``stream`` (a raw
    handle); raise on a launch error."""
    err = getattr(library(), name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


@functools.lru_cache(maxsize=128)
def workspace_bytes(name, *args):
    """Device bytes the workspace query ``name`` (``grid_bins_workspace``,
    ``slab_plan_workspace`` or ``column_plan_workspace``) reports for
    ``args``: the chain's key and id double buffers, packed spheres,
    bounds partials, its own parts and cub's temporary storage
    (``csrc/bucket_sort.cuh``)."""
    out = ctypes.c_longlong()
    err = getattr(library(), name)(*args, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return out.value


def spheres(coords, radii):
    """``(coords, radii, n)``, contiguous, once coords is [n, 3] and radii
    [n]; raises ValueError otherwise."""
    n = coords.shape[0]
    if tuple(coords.shape) != (n, 3) or tuple(radii.shape) != (n,):
        raise ValueError(f"coords must be [n, 3] and radii [n], got "
                         f"{tuple(coords.shape)} and {tuple(radii.shape)}")
    return coords.contiguous(), radii.contiguous(), n


def require(t, dtype, name):
    """Check that ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device}")
    return t.data_ptr()
