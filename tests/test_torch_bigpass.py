"""Port parity: the hetero engine's pieces against the JAX package's, on
the same numpy scenes: the big split and the bigs table, the big pass's
row ranges and its two kernels' plain versions (against the JAX Pallas
kernels in interpret mode, on one table and one stream carried across),
the residual jobs past ``base`` rows (slab and column stencils), and the
dual dispatch at two rows. Integer outputs: equality is exact; the table
and the stream compare as bit patterns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import columns as jcolumns
from collision_tpu import fill as jfill
from collision_tpu import hetero as jhetero
from collision_tpu import slabs as jslabs
from collision_tpu.kernels import bigpass as jbigpass
from collision_tpu.kernels import slab_sweep as jslab_sweep
from collision_tpu.kernels import sweep as jsweep
from collision_tpu_torch import columns, fill, hetero, slabs
from collision_tpu_torch.kernels import bigpass, slab_sweep, sweep
from collision_tpu_torch.testing.scenes import touching_big_pass


def _power_law(n=1500, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.35).astype("float32")
    return coords, radii


def _tied(n=3000, seed=5):
    # A third of the radii tied at the top: the big set's order is the
    # tie order of the top-k.
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = np.zeros(n, dtype="float32")
    radii[::3] = 0.02
    return coords, radii


def _fields(plan):
    return {k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in plan._asdict().items()}


def _jax_split(coords, radii, nb):
    _, bidx = jax.lax.top_k(jnp.asarray(radii), nb)
    bidx = bidx.astype(jnp.int32)
    bigs = jhetero._bigs_table(jnp.asarray(coords), jnp.asarray(radii),
                               bidx, nb)
    parked = radii.copy()
    parked[np.asarray(bidx)] = -np.inf
    return np.asarray(bidx), tuple(np.asarray(a) for a in bigs), parked


@pytest.mark.parametrize("scene,nb", [(_power_law, 128), (_tied, 320)])
def test_bigs_table_bit_identical(scene, nb):
    coords, radii = scene()
    jbidx, jbigs, _ = _jax_split(coords, radii, nb)
    bidx = hetero._big_indices(torch.from_numpy(radii), nb)
    np.testing.assert_array_equal(bidx.numpy(), jbidx)
    rows, zlo, zhi = hetero._bigs_table(torch.from_numpy(coords),
                                        torch.from_numpy(radii), bidx, nb)
    for got, want in zip((rows, zlo, zhi), jbigs):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_tied_radii_keep_jax_order():
    # torch.topk orders ties otherwise; the port must not use it.
    _, radii = _tied()
    want = np.asarray(jax.lax.top_k(jnp.asarray(radii), 8)[1])
    np.testing.assert_array_equal(want, np.arange(0, 24, 3))
    got = hetero._big_indices(torch.from_numpy(radii), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def big_case():
    """The power-law scene's JAX bigs table and parked column plan's
    stream, on both sides, and the JAX big pass's results."""
    coords, radii = _power_law()
    nb = 128
    _, jbigs, parked = _jax_split(coords, radii, nb)
    gxy, cap, rows = columns.default_column_config(len(coords))
    jplan = jcolumns.plan_columns(jnp.asarray(coords), jnp.asarray(parked),
                                  gxy, cap, rows)
    bigs = hetero.bigs_from_numpy(jbigs, "cpu")
    stream = torch.from_numpy(np.array(jplan.stream))
    return jbigs, jplan.stream, bigs, stream


def test_row_ranges_match_jax(big_case):
    jbigs, jstream, bigs, stream = big_case
    nbc = jbigs[0].shape[0]
    padded, nblk = jbigpass._pad_stream(jstream)
    jc0, jc1, jn = jbigpass._row_ranges(padded, jnp.asarray(jbigs[1]),
                                        jnp.asarray(jbigs[2]), nbc, nblk)
    c0, c1, n_always = bigpass._row_ranges(stream, bigs[1], bigs[2])
    rp = stream.shape[0]
    assert n_always == jn == 1 and c0.dtype == torch.int32
    np.testing.assert_array_equal(c0.numpy(), np.asarray(jc0)[:rp])
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1)[:rp])
    assert (c1 > c0).any()       # the z gating is exercised


def test_big_count_matches_pallas(big_case):
    # The power-law scene, then the big count kernel's cull edges: bigs
    # on the faces of the rows' union boxes, a row of pad lanes only and
    # a row of parked lanes (testing/scenes.py).
    *jbigs, jstream = touching_big_pass()
    for jbigs, jstream, bigs, stream in (
            big_case, (jbigs, jstream, hetero.bigs_from_numpy(jbigs, "cpu"),
                       torch.from_numpy(jstream))):
        jtot, jok = jbigpass.big_count_only(
            tuple(map(jnp.asarray, jbigs)), jnp.asarray(jstream),
            interpret=True)
        tot, ok = bigpass.big_count_only(bigs, stream)
        assert tot.dtype == torch.int64 and bool(ok) == bool(jok)
        assert int(tot) == int(jtot) > 0


def _cuts(bigs, stream):
    """(total, a capacity that cuts inside one row's hits, another)."""
    c0, c1, n_always = bigpass._row_ranges(stream, bigs[1], bigs[2])
    per_row = bigpass._tile_hits_plain(
        bigs[0], c0, c1, n_always, stream, 0, stream.shape[0]).sum((1, 2, 3))
    row = int(torch.nonzero(per_row >= 2)[len(per_row) // 2 % 3, 0])
    inside = int(per_row[:row].sum()) + 1
    total = int(per_row.sum())
    return total, inside, total // 3


def test_big_pairs_match_pallas(big_case):
    jbigs, jstream, bigs, stream = big_case
    total, inside, third = _cuts(bigs, stream)
    for capacity in (total + 40, inside, third):
        ja, jb, jtot, jok = jbigpass.big_pairs(
            tuple(map(jnp.asarray, jbigs)), jstream, capacity,
            interpret=True)
        ida, idb, tot, ok = bigpass.big_pairs(bigs, stream, capacity)
        assert int(tot) == int(jtot) == total and bool(ok) == bool(jok)
        np.testing.assert_array_equal(ida.numpy(),
                                      np.asarray(ja).astype(np.int64))
        np.testing.assert_array_equal(idb.numpy(),
                                      np.asarray(jb).astype(np.int64))


def _slab_plans(n, r_max, seed, gx, cap, rows):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, r_max, n).astype("float32")
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), gx, cap,
                           rows)
    return jp, slabs.plan_from_numpy(_fields(jp), "cpu")


def _column_plans(n, r_max, seed, gxy):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, r_max, n).astype("float32")
    gxy, cap, rows = columns.default_column_config(n, gxy=gxy)
    jp = jcolumns.plan_columns(jnp.asarray(coords), jnp.asarray(radii), gxy,
                               cap, rows)
    return jp, columns.plan_from_numpy(_fields(jp), "cpu")


#: Windows past 256 lanes: residual jobs at base 1 and 2.
WIDE_SLAB = (1200, 0.25, 19, 1, 1216, 12)
WIDE_COLUMN = (700, 0.2, 3, 1)


@pytest.mark.parametrize("stencil,base", [("slab", 2), ("column", 1),
                                          ("column", 2)])
def test_residual_tables_match_jax(stencil, base):
    if stencil == "slab":
        jp, tp = _slab_plans(*WIDE_SLAB)
        noff, j_cap = 2, 512
    else:
        jp, tp = _column_plans(*WIDE_COLUMN)
        noff, j_cap = 5, 64
    want = jslabs._residual_mask_tables(
        jp.stream, jp.starts, jp.w0.reshape(-1), jp.wcap.reshape(-1), jp.mc,
        noff, j_cap, 0, base=base)
    got = slabs._residual_mask_tables(
        tp.stream, tp.starts, tp.w0.reshape(-1), tp.wcap.reshape(-1), tp.mc,
        noff, j_cap, base)
    assert bool(got[3]) == bool(want[3]) and bool(got[3])
    assert got[0].any()          # jobs exist past the base rows
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    if stencil == "column":
        jc, jok = jsweep.column_residual_count(jp, j_cap=j_cap, base=base)
        tc, tok = sweep.column_residual_count(tp, j_cap=j_cap, base=base)
        assert int(tc) == int(jc) and bool(tok) == bool(jok)


def test_residual_pairs_at_base2():
    jp, tp = _slab_plans(*WIDE_SLAB)
    ja, jb, jc, jok = jslabs.residual_pairs(jp, j_cap=jslabs.RESIDUAL_JOBS,
                                            interpret=True, base=2)
    ta, tb, tc, tok = slabs.residual_pairs(tp, base=2)
    assert int(tc) == int(jc) > 0 and bool(tok) == bool(jok)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))


def test_slab_count_dual_base2_matches_pallas():
    jp, tp = _slab_plans(*WIDE_SLAB)
    jc, jr_ok, jno = jslab_sweep.slab_count_dual(
        jp, interpret=True, split_ok=True, base=2, j_cap=512)
    tc, tr_ok, tno = slab_sweep.slab_count_dual(tp, j_cap=512, split_ok=True,
                                                base=2)
    assert (bool(tr_ok), bool(tno)) == (bool(jr_ok), bool(jno)) == (True, True)
    assert int(tc) == int(jc)


def test_slab_fill_from_plan_base2_matches_pallas():
    # 6632 mask pairs, then 14 residual pairs: the cut falls among the
    # residual pairs.
    jp, tp = _slab_plans(900, 0.12, 17, 1, 960, 10)
    capacity = 6640
    ja, jb, jt, jgx, jother = jfill.slab_fill_from_plan(
        jp, capacity, interpret=True, dual=True, split_ok=True, dual_base=2)
    ta, tb, tt, tgx, tother = fill.slab_fill_from_plan(
        tp, capacity, dual_base=2, split_ok=True)
    assert int(tt) == int(jt) == 6646
    assert (bool(tgx), bool(tother)) == (bool(jgx), bool(jother))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))


@pytest.mark.parametrize("base", [1, 2])
def test_sweep_count_dual_matches_pallas(base):
    jp, tp = _column_plans(*WIDE_COLUMN)
    jc, jok = jsweep.sweep_count_dual(jp, interpret=True, base=base)
    tc, tok = sweep.sweep_count_dual(tp, base=base)
    assert bool(tok) == bool(jok) and bool(tok)
    assert int(tc) == int(jc)
    assert sweep.default_column_j_cap(tp, base) \
        == jsweep.default_column_j_cap(jp, base)
