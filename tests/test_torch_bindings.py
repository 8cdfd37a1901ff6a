"""The ctypes bindings of collision_tpu_torch's kernels against their C
entry points, and the grid emission's internal hit count, on the CPU.

``kernels/_build._ARGTYPES`` gives each ``extern "C"`` function of
``collision_tpu_torch/csrc/*.cu`` one ctypes type per parameter. A wrong
one passes a pointer or a length cut to 32 bits, which only the card
would show; these tests read the sources instead. Imports no JAX.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from collision_tpu_torch import grid
from collision_tpu_torch.kernels import _build, emit
from collision_tpu_torch.testing.scenes import GRID_SCENES

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _entry_points():
    """{name: [parameter declarations]} of every extern "C" function."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            assert name not in out, f"{name} defined twice"
            out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


def _ctype(param):
    """The ctypes type a C parameter declaration takes."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const ", "").split()[:-1]   # drop the name
    types = {("long", "long"): ctypes.c_longlong, ("int",): ctypes.c_int,
             ("unsigned",): ctypes.c_uint, ("unsigned", "int"): ctypes.c_uint}
    assert tuple(words) in types, f"no ctypes type for {param!r}"
    return types[tuple(words)]


def test_every_entry_point_is_bound():
    assert set(_entry_points()) == set(_build._ARGTYPES)


@pytest.mark.parametrize("name", sorted(_build._ARGTYPES))
def test_argtypes_match_the_c_parameters(name):
    params = _entry_points()[name]
    assert [_ctype(p) for p in params] == _build._ARGTYPES[name], params


@pytest.mark.parametrize("name", ["half_cell_radii", "full_cell_beside_empty"])
def test_emit_pairs_hit_count_leaves_the_buffer(name):
    # n_hit is grid_fill's internal keyword: with it the emission reads
    # only the leading hit tiles and stops each at the next base, so the
    # buffer must be the one the entries give without it.
    coords, radii, gd, mc = GRID_SCENES[name]()
    bins, ok, _ = grid.build_grid(torch.from_numpy(coords),
                                  torch.from_numpy(radii), gd, mc)
    assert bool(ok)
    flat = emit.halo_tile_counts(bins, gd, mc).reshape(-1)
    total = int(flat.sum())
    first = int(torch.nonzero(flat >= 2)[0])
    boundary = int(flat[:int(torch.nonzero(flat).flatten()[-1])].sum())
    for capacity in (total + 100, int(flat[:first].sum()) + 1, 1, boundary):
        tiles, bases, n_hit = emit.fill_entries(flat, capacity)
        assert int(n_hit) == int((flat > 0).sum())
        args = (bins, tiles, bases, gd, mc, capacity)
        want = emit.emit_pairs(*args)
        assert torch.equal(emit.emit_pairs(*args, n_hit=n_hit), want)
        assert torch.equal(emit.grid_fill(bins, gd, mc, capacity)[0], want)
        # A hit count below the entries' skips the rest: their pairs stay
        # unwritten.
        cut = emit.emit_pairs(*args, n_hit=torch.tensor(1))
        assert torch.equal(cut, emit.emit_pairs(bins, tiles[:1], bases[:1],
                                                gd, mc, capacity))
    assert bool((want[:total] != 0xFFFFFFFF).all())


def test_diag_span_tiles_the_domain():
    # The diagonal kernel takes DIAG_THREADS * DIAG_K positions a block;
    # the domain (Rp - DIAG_B) * 128 is a multiple of DIAG_B * 128. Its
    # staged columns skip a word every DIAG_K, so that a warp's reads at
    # DIAG_K * lane + j land in (DIAG_K + 1) * lane + const: 32 banks iff
    # DIAG_K is even.
    from collision_tpu_torch.slabs import DIAG_B

    src = (CSRC / "slab_sweep.cu").read_text()
    threads = int(re.search(r"constexpr int DIAG_THREADS = (\d+);", src)[1])
    k = int(re.search(r"constexpr int DIAG_K = (\d+);", src)[1])
    assert (DIAG_B * 128) % (threads * k) == 0
    assert k % 2 == 0
