"""Port parity: the pair emission above BIG_FILL_THRESHOLD.

``kernels/pair_emit.emit_pairs_plain`` (what ``emit_pairs`` runs on a CPU
tensor) against the JAX ``emit_pairs`` kernel in interpret mode, on one
set of tables carried across with numpy; the port's fills through the
sparse emission and through the kernel's against each other and against
the JAX fill's kernel mode; and ``collide`` at a capacity past the
threshold against its sparse prefix. Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collision_tpu.fill as jfill
from collision_tpu.kernels.pair_emit import emit_pairs as jax_emit_pairs
from collision_tpu_torch import collide, columns, fill, slabs
from collision_tpu_torch.kernels import pair_emit, slab_sweep, sweep
from collision_tpu_torch.slabs import NO_PAIR
from collision_tpu_torch.testing import brute_force_collisions, pair_array_to_set

# The scenes of the JAX package's emission tests (tests/test_fill.py):
# (engine, n, seed, grid, col_capacity, slab_rows, radius scale).
SCENES = [
    ("column", 200, 0, 2, 192, 4, 1.2),
    ("column", 1000, 2, 4, 128, 6, 1.2),
    ("column", 600, 9, 2, 512, 8, 1.2),
    ("column", 800, 5, 1, 832, 9, 6.0),    # 22k pairs through one column
    ("slab", 1200, 11, 4, 448, 9, 1.2),    # rolled rows, unaligned windows
]


def _points(n, seed, rscale):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype("float32")
    return coords, radii


def _masks_and_tables(engine, n, seed, grid, cc, sr, rscale):
    """(B, wstart_tab, cb_tab, ids, total) of a scene's plan at the
    rows-per-window rung its windows need."""
    coords, radii = _points(n, seed, rscale)
    args = (torch.from_numpy(coords), torch.from_numpy(radii), grid, cc, sr)
    if engine == "column":
        plan = columns.plan_columns(*args)
        rpw = next(r for r in sweep.RPW_LADDER if r >= int(plan.rows_needed))
        B = sweep.sweep_masks(plan, rpw)
    else:
        plan = slabs.plan_slabs(*args)
        rpw = next(r for r in sweep.RPW_LADDER if r >= int(plan.rows_rolled))
        B = slab_sweep.slab_sweep_masks(plan, rpw)
    assert bool(plan.ok)
    ws, cb = fill._emit_tables(B, plan.starts.long(), plan.w0.reshape(-1).long(),
                               plan.mc, 5 if engine == "column" else 2, rpw,
                               rolled=engine == "slab")
    return B, ws, cb, fill._sorted_ids(plan), int(pair_emit.row_popcounts(B).sum())


@pytest.mark.parametrize("scene", SCENES)
def test_emit_pairs_plain_matches_jax(scene):
    # One JAX run at full capacity; the port's cut at 32 slots is held to
    # its prefix.
    B, ws, cb, ids, total = _masks_and_tables(*scene)
    want_a, want_b = (np.asarray(w) for w in jax_emit_pairs(
        jnp.asarray(B.numpy().view(np.uint32)),
        jnp.asarray(ws.numpy().astype(np.int32)),
        jnp.asarray(cb.numpy().astype(np.int32)),
        jnp.asarray(ids.numpy().astype(np.uint32)), total + 9,
        interpret=True))
    for capacity in (total + 9, 32):
        got_a, got_b = pair_emit.emit_pairs(B, ws, cb, ids, capacity)
        k = min(total, capacity)
        np.testing.assert_array_equal(got_a[:k].numpy(), want_a[:k])
        np.testing.assert_array_equal(got_b[:k].numpy(), want_b[:k])
        assert (got_a[k:] == NO_PAIR).all() and (got_b[k:] == NO_PAIR).all()


def test_emit_pairs_plain_blocks_and_row_table():
    # Any block size, and the caller's row popcounts in place of the
    # function's own, give the same buffers; a cut inside one row keeps
    # that row's first pairs.
    B, ws, cb, ids, total = _masks_and_tables(*SCENES[1])
    rp = pair_emit.row_popcounts(B)
    cum = torch.cumsum(rp, 0)
    row = int(torch.nonzero(rp > 1)[0])
    cut = int(cum[row]) - 1                       # one pair short of the row
    for capacity in (total, cut):
        want = pair_emit.emit_pairs_plain(B, ws, cb, ids, capacity)
        for kwargs in ({"blk": 7}, {"blk": 1}, {"rp_tab": rp.view(B.shape[:2])}):
            got = pair_emit.emit_pairs_plain(B, ws, cb, ids, capacity, **kwargs)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_emit_pairs_plain_ids_end_at_the_last_sphere():
    # The slab plan's last rolled window rows run past the last sphere;
    # the pairs only read ids below it.
    B, ws, cb, ids, total = _masks_and_tables(*SCENES[4])
    n = SCENES[4][1]
    assert int(ws.max()) + 128 > n
    want = pair_emit.emit_pairs_plain(B, ws, cb, ids, total)
    got = pair_emit.emit_pairs_plain(B, ws, cb, ids[:n], total)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_row_popcounts_in_passes(monkeypatch):
    B, *_ = _masks_and_tables(*SCENES[3])
    want = pair_emit.row_popcounts(B)
    monkeypatch.setattr(pair_emit, "_POPCOUNT_ROWS", 3)
    assert torch.equal(pair_emit.row_popcounts(B), want)
    words = B.reshape(-1, 128).numpy().view(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(want.numpy(), bits)


def _width_masks(kind):
    """int32 [1, rows, 128] masks: rows of every width 0-64 then a full
    row and two empty ones (bits at random places), rows of all ones, or
    random words."""
    rng = np.random.RandomState(13)
    if kind == "widths":
        width = np.r_[np.arange(65), 4096, 0, 0]
        bits = rng.random((width.size, 4096)).argsort(axis=1) < width[:, None]
    elif kind == "ones":
        bits = np.ones((4, 4096), bool)
    else:
        bits = rng.random((6, 4096)) < 0.5
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    return torch.from_numpy(words.view(np.int32).reshape(1, -1, 128).copy()), bits


@pytest.mark.parametrize("kind", ["widths", "ones", "random"])
def test_row_popcounts_plain_matches_unpackbits(kind):
    B, bits = _width_masks(kind)
    got = pair_emit.row_popcounts_plain(B)
    assert got.dtype == torch.int64
    words = B.reshape(-1, 128).numpy().view(np.uint32)
    want = np.unpackbits(words.view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bits.sum(axis=1))
    assert torch.equal(pair_emit.row_popcounts(B), got)


@pytest.mark.parametrize("cut", ["none", "mid_full_row", "zero", "one"])
def test_emit_pairs_plain_contract(cut):
    # Against a numpy decode of the masks in (row, lane, bit) order: int64
    # uint32 ids (past 2^31 too), the first `capacity` pairs, 0xFFFFFFFF
    # after them; tables past both ends of the ids are clamped.
    B, bits = _width_masks("widths")
    rows = B.shape[1]
    rng = np.random.RandomState(17)
    nsort = 300
    ws = rng.randint(-20, nsort + 20, (1, rows // 2))
    cb = rng.randint(-10, nsort + 10, (1, rows // 2))
    ids = rng.randint(0, 1 << 32, nsort, dtype=np.uint64).astype(np.int64)
    r, q = np.nonzero(bits)                        # row-major: (row, lane, bit)
    a = np.clip(cb[0, r // 2] + (r % 2) * 32 + q % 32, 0, nsort - 1)
    b = np.clip(ws[0, r // 2] + q // 32, 0, nsort - 1)
    total = r.size
    full = int(bits[:65].sum())                    # the full row's first slot
    capacity = {"none": total + 7, "mid_full_row": full + 2048, "zero": 0,
                "one": 1}[cut]
    ida, idb = pair_emit.emit_pairs(B, torch.from_numpy(ws), torch.from_numpy(cb),
                                    torch.from_numpy(ids), capacity)
    assert ida.dtype == idb.dtype == torch.int64
    assert ida.shape == idb.shape == (capacity,)
    k = min(total, capacity)
    np.testing.assert_array_equal(ida[:k].numpy(), ids[a[:k]])
    np.testing.assert_array_equal(idb[:k].numpy(), ids[b[:k]])
    assert (ida[k:] == NO_PAIR).all() and (idb[k:] == NO_PAIR).all()


@pytest.mark.parametrize("engine", ["column", "slab"])
def test_fill_emit_modes_match_jax_kernel_mode(engine, monkeypatch):
    # The fill at the threshold's own value takes the sparse emission,
    # at a threshold of 0 the kernel's (its plain version on the CPU).
    if engine == "column":
        _, n, seed, gxy, cc, sr, rscale = SCENES[1]
        coords, radii = _points(n, seed, rscale)
        rpw = 2
        port = lambda cap: fill.mask_fill(               # noqa: E731
            torch.from_numpy(coords), torch.from_numpy(radii), cap, gxy, cc,
            sr, rpw=rpw)
        jax_fill = lambda cap: jfill.mask_fill(           # noqa: E731
            jnp.asarray(coords), jnp.asarray(radii), cap, gxy, cc, sr,
            rpw=rpw, interpret=True, emit_mode="kernel")
    else:
        _, n, seed, gx, cc, sr, rscale = SCENES[4]
        coords, radii = _points(n, seed, rscale)
        port = lambda cap: fill.slab_mask_fill(          # noqa: E731
            torch.from_numpy(coords), torch.from_numpy(radii), cap, gx, cc,
            sr)
        jax_fill = lambda cap: jfill.slab_mask_fill(      # noqa: E731
            jnp.asarray(coords), jnp.asarray(radii), cap, gx, cc, sr,
            interpret=True, emit_mode="kernel", dual=True)
    expected = brute_force_collisions(coords, radii)
    for capacity in (32, len(expected) + 9):
        monkeypatch.setattr(fill, "BIG_FILL_THRESHOLD", 1 << 21)
        assert fill._pick_emit(capacity) is fill._mask_fill_emit
        sparse = port(capacity)
        monkeypatch.setattr(fill, "BIG_FILL_THRESHOLD", 0)
        assert fill._pick_emit(capacity) is fill._mask_fill_emit_kernel
        kernel = port(capacity)
        for ida, idb, total, ok in (sparse, kernel):
            assert bool(ok) and int(total) == len(expected)
        assert torch.equal(kernel[0], sparse[0]) and torch.equal(kernel[1], sparse[1])
    got = kernel
    want = jax_fill(len(expected) + 9)
    assert bool(want[3]) and int(want[2]) == int(got[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
    assert pair_array_to_set(torch.stack(got[:2], dim=1), len(expected)) == expected


@pytest.mark.parametrize("emitter", ["sparse", "kernel"])
@pytest.mark.parametrize("engine", ["column", "slab", "slab_split"])
def test_fill_pair_buffers_are_the_fills_columns(engine, emitter,
                                                 monkeypatch):
    # The buffer forms on the scenes above: a contiguous int64
    # [capacity, 2] buffer whose columns are the JAX-named fills' ida and
    # idb (views of one buffer), the same totals and flags, under both
    # emitters, and the pairs of the scene.
    monkeypatch.setattr(fill, "BIG_FILL_THRESHOLD",
                        1 << 21 if emitter == "sparse" else 0)
    if engine == "column":
        _, n, seed, gxy, cc, sr, rscale = SCENES[1]
        coords, radii = _points(n, seed, rscale)
        plan = columns.plan_columns(torch.from_numpy(coords),
                                    torch.from_numpy(radii), gxy, cc, sr)
        buffer = lambda cap: fill.column_fill_pairs(plan, cap, 2)  # noqa: E731
        named = lambda cap: fill.column_fill_from_plan(plan, cap, 2)  # noqa: E731
    else:
        _, n, seed, gx, cc, sr, rscale = SCENES[4]
        coords, radii = _points(n, seed, rscale)
        plan = slabs.plan_slabs(torch.from_numpy(coords),
                                torch.from_numpy(radii), gx, cc, sr)
        split = engine == "slab_split"
        buffer = lambda cap: fill.slab_fill_pairs(  # noqa: E731
            plan, cap, split_ok=split)
        named = lambda cap: fill.slab_fill_from_plan(  # noqa: E731
            plan, cap, split_ok=split)
    expected = brute_force_collisions(coords, radii)
    for capacity in (32, len(expected) + 9):
        pairs, *flags = buffer(capacity)
        ida, idb, *want_flags = named(capacity)
        assert pairs.dtype == torch.int64 and pairs.shape == (capacity, 2)
        assert pairs.is_contiguous()
        assert ida.stride() == idb.stride() == (2,)
        assert idb.data_ptr() - ida.data_ptr() == ida.element_size()
        assert torch.equal(pairs[:, 0], ida) and torch.equal(pairs[:, 1], idb)
        assert len(flags) == len(want_flags) == (3 if engine == "slab_split"
                                                 else 2)
        for got, want in zip(flags, want_flags):
            assert torch.equal(got, want)
        assert all(bool(f) for f in flags[1:])
        assert int(flags[0]) == len(expected)
    assert pair_array_to_set(pairs, len(expected)) == expected
    assert (pairs[len(expected):] == NO_PAIR).all()


@pytest.mark.parametrize("method", ["column", "slab", "hetero"])
def test_collide_above_big_fill_threshold(method):
    rng = np.random.RandomState(7)
    n = 1500
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1.5 / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    args = (torch.from_numpy(coords), torch.from_numpy(radii))
    sparse = collide(*args, len(expected) + 8, method=method)
    big = collide(*args, fill.BIG_FILL_THRESHOLD + 8, method=method)
    assert bool(sparse.ok) and bool(big.ok)
    assert int(big.count) == int(sparse.count) == len(expected)
    assert torch.equal(big.pairs[:len(expected)], sparse.pairs[:len(expected)])
    assert (big.pairs[len(expected):] == NO_PAIR).all()
    assert pair_array_to_set(big.pairs, big.count) == expected


def test_pick_emit_routes_by_capacity():
    t = fill.BIG_FILL_THRESHOLD
    assert fill._pick_emit(t) is fill._mask_fill_emit
    assert fill._pick_emit(t + 1) is fill._mask_fill_emit_kernel
    assert fill._pick_emit(1 << 27) is fill._mask_fill_emit_kernel
    assert jfill.BIG_FILL_THRESHOLD == t
