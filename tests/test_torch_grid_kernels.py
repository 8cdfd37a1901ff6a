"""Port parity: the plain versions of the grid kernels (kernels/halo.py,
kernels/batched.py, kernels/emit.py) against the JAX package's Pallas
kernels in interpret mode, on the same bins (``build_grid`` is
bit-identical, tests/test_torch_grid.py), random scenes and the scenes
at the grid count kernel's cull edges. Totals, tile counts and pair
buffers must be equal, truncated buffers included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import grid as jgrid
from collision_tpu.kernels import batched as jbatched
from collision_tpu.kernels import compact as jcompact
from collision_tpu.kernels import emit as jemit
from collision_tpu.kernels import halo as jhalo
from collision_tpu.ops.scan import exclusive_scan
from collision_tpu_torch.grid import build_grid
from collision_tpu_torch.kernels import batched, emit, halo
from collision_tpu_torch.testing import brute_force_collisions
from collision_tpu_torch.testing.scenes import GRID_SCENES


def _bins(n, gd, mc, rscale=1.5):
    """Bins of n spheres from seed n, radii U(0, rscale/sqrt(n)), or, for
    a scene name, of that scene of testing/scenes.py at its own grid_dim
    and cell_capacity (gd and mc must name them)."""
    if isinstance(n, str):
        coords, radii, sgd, smc = GRID_SCENES[n]()
        assert (sgd, smc) == (gd, mc)
    else:
        rng = np.random.RandomState(n)
        coords = rng.random((n, 3)).astype("float32")
        radii = rng.uniform(0, rscale / np.sqrt(n), n).astype("float32")
    jbins, jok, _ = jgrid.build_grid(jnp.asarray(coords), jnp.asarray(radii),
                                     gd, mc)
    bins, ok, _ = build_grid(torch.from_numpy(coords), torch.from_numpy(radii),
                             gd, mc)
    assert bool(ok) and bool(jok)
    return coords, radii, jbins, bins


def _cut_inside_a_tile(flat):
    """A capacity that ends inside the first tile holding >= 2 pairs."""
    flat = np.asarray(flat).reshape(-1)
    t = int(np.nonzero(flat >= 2)[0][0])
    return int(flat[:t].sum()) + 1


def _pairs(p):
    return np.asarray(p).astype(np.int64)


@pytest.mark.parametrize("n,gd,mc", [
    (400, 4, 64), (300, 5, 32),
    # The grid count kernel's cull edges, held here to the JAX kernel so
    # that the plain version the card compares with is right on them.
    ("touching_lattice", 4, 32), ("half_cell_radii", 4, 32),
    ("full_cell_beside_empty", 4, 320)])
def test_halo_pairs_plain_matches_jax(n, gd, mc):
    coords, radii, jbins, bins = _bins(n, gd, mc)
    expected = len(brute_force_collisions(coords, radii))
    got_none, total = halo.halo_pairs(bins, gd, mc, 0)
    _, jtotal = jhalo.halo_pairs(jbins, gd, mc, 0, interpret=True)
    assert got_none is None and total.dtype == torch.int64
    assert int(total) == int(jtotal) == expected
    cut = _cut_inside_a_tile(emit.halo_tile_counts(bins, gd, mc))
    for capacity in (expected + 8, cut):
        pairs, total = halo.halo_pairs(bins, gd, mc, capacity)
        jpairs, jtotal = jhalo.halo_pairs(jbins, gd, mc, capacity,
                                          interpret=True)
        assert int(total) == int(jtotal) == expected
        np.testing.assert_array_equal(pairs.numpy(), _pairs(jpairs))
        # The split fill writes the same buffer.
        fill, fill_total = emit.grid_fill(bins, gd, mc, capacity)
        assert torch.equal(fill, pairs) and int(fill_total) == expected


@pytest.mark.parametrize("n,gd,mc", [(500, 8, 16), (1200, 2, 200)])
def test_batched_count_plain_matches_jax(n, gd, mc):
    # (1200, 2, 200): ~150 spheres a cell, more than one 128-row chunk.
    coords, radii, jbins, bins = _bins(n, gd, mc)
    got = batched.batched_count(bins, gd, mc)
    want = jbatched.batched_count(jbins, gd, mc, interpret=True)
    assert got.dtype == torch.int64
    assert int(got) == int(want) == len(brute_force_collisions(coords, radii))
    with pytest.raises(ValueError, match="even"):
        batched.batched_count(bins[:-1, :-1, :-1], gd - 1, mc)


def test_tile_counts_and_emit_pairs_match_jax():
    gd, mc = 6, 32
    _, _, jbins, bins = _bins(700, gd, mc)
    jtc = jemit.halo_tile_counts(jbins, gd, mc, interpret=True)
    tc = emit.halo_tile_counts(bins, gd, mc)
    assert tc.dtype == torch.int32
    assert tuple(tc.shape) == (gd * gd, emit.tile_pad(gd)) == (36, 128)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jtc))
    assert not tc[:, 14 * gd:].any()
    # JAX's own hit tiles and bases, fed to both emitters.
    flat = jnp.asarray(jtc).reshape(-1)
    total = int(flat.sum())
    bases = exclusive_scan(flat)
    hit, _ = jcompact.compact_mask(flat > 0, 512, interpret=True)
    valid = hit != jcompact.NO_INDEX
    tiles = jnp.where(valid, hit, 0).astype(jnp.int32)
    for capacity in (total + 8, _cut_inside_a_tile(jtc)):
        tbases = jnp.where(valid, jnp.take(bases, tiles), capacity) \
            .astype(jnp.int32)
        want = jemit.emit_pairs(jbins, tiles, tbases, gd, mc, capacity,
                                interpret=True)
        got = emit.emit_pairs(bins, torch.from_numpy(np.array(tiles)),
                              torch.from_numpy(np.array(tbases)), gd, mc,
                              capacity)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), _pairs(want))
