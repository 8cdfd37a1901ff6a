"""The CUDA kernels of collision_tpu_torch against their plain PyTorch
versions, and ``collide`` and ``Collider`` on the card against the same
calls on the CPU.

Needs an NVIDIA GPU and the CUDA toolkit: every test skips without a
card. Imports no JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from collision_tpu_torch import (Collider, collide, collide_exact, columns, fill,
                                 grid, hetero, slabs)
from collision_tpu_torch.kernels import (_build, batched, bigpass, compact, emit,
                                         halo, pair_emit, slab_sweep, sweep)
from collision_tpu_torch.testing.scenes import COLUMN_SCENES as CULL_COLUMN_SCENES
from collision_tpu_torch.testing.scenes import GRID_SCENES as CULL_GRID_SCENES
from collision_tpu_torch.testing.scenes import SLAB_EDGES, slab_edges
from collision_tpu_torch.testing.scenes import SLAB_SCENES as CULL_SLAB_SCENES
from collision_tpu_torch.testing.scenes import touching_big_pass

pytestmark = pytest.mark.cuda

SCENES = [
    # n, r_max, seed, gx (None: default config)
    (2000, 1 / np.sqrt(2000), 0, None),
    (20000, 0.001, 1, 300),    # zbits = 23
    (900, 0.12, 17, 2),                    # windows past 128 lanes
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scene(n, r_max, seed):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, r_max, n).astype("float32")
    return torch.from_numpy(coords), torch.from_numpy(radii)


@pytest.mark.parametrize("scene", SCENES)
def test_sweep_kernels_match_plain(cuda, scene):
    n, r_max, seed, gx = scene
    coords, radii = _scene(n, r_max, seed)
    gx, cap, rows = slabs.default_slab_config(n, gx=gx)
    plan = slabs.plan_slabs(coords.to(cuda), radii.to(cuda), gx, cap, rows)
    args = (plan.stream, plan.starts, plan.w0, plan.wcap)
    before = dict(_build.LAUNCHES)
    assert int(slab_sweep.slab_window_count(*args)) \
        == int(slab_sweep.slab_window_count_plain(*args))
    assert torch.equal(slab_sweep.slab_masks(*args),
                       slab_sweep.slab_masks_plain(*args))
    # The diagonal count's cross-only pass: offset x+1, j > i + 48.
    assert int(slab_sweep.slab_window_count(*args, first_off=1, dmin=48)) \
        == int(slab_sweep.slab_window_count_plain(*args, first_off=1,
                                                  dmin=48))
    assert _build.LAUNCHES["slab_count"] == before["slab_count"] + 2
    assert _build.LAUNCHES["slab_masks"] == before["slab_masks"] + 1


@pytest.mark.parametrize("n,density,capacity", [
    (0, 0.0, 8),
    (5, 1.0, 3),
    (4097, 0.03, 0),
    (200_003, 0.03, 100),
    (5_000_000, 0.001, 10_000),   # more tiles than the scan block's threads
])
def test_compact_kernel_matches_plain(cuda, n, density, capacity):
    gen = torch.Generator(device=cuda).manual_seed(n)
    mask = torch.rand(n, device=cuda, generator=gen) < density
    idx, total = compact.compact_mask(mask, capacity)
    pidx, ptotal = compact.compact_mask_plain(mask, capacity)
    assert int(total) == int(ptotal)
    assert torch.equal(idx, pidx)


def _edge_mask(n, pattern):
    """A bool mask of n elements: all set, none, only the last, or 30%."""
    if pattern == "random":
        return torch.from_numpy(np.random.RandomState(n).random(n) < 0.3)
    mask = torch.full((n,), pattern == "all")
    if pattern == "last":
        mask[-1] = True
    return mask


def _check_compact(mask, capacity, got):
    idx, total = got
    want_idx, want_total = compact.compact_mask_plain(mask, capacity)
    assert idx.dtype == total.dtype == torch.int64 and total.dim() == 0
    assert int(total) == int(want_total)
    assert torch.equal(idx, want_idx)


@pytest.mark.parametrize("pattern", ["all", "none", "last", "random"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 1])
def test_compact_kernel_edges_match_plain(cuda, n, pattern):
    # Tiles of one element, one short of a tile, one, one past, and three
    # and one element; capacity below, at and above the total, 0 and 1.
    mask = _edge_mask(n, pattern).to(cuda)
    total = int(mask.sum())
    before = _build.LAUNCHES["compact_mask"]
    capacities = sorted({max(total - 1, 0), total, total + 5, 0, 1})
    for capacity in capacities:
        _check_compact(mask, capacity, compact.compact_mask(mask, capacity))
    assert _build.LAUNCHES["compact_mask"] == before + len(capacities)


def test_compact_kernel_back_to_back(cuda, monkeypatch):
    # 1000 calls in a row on one stream's look-back state, without a sync,
    # through two wraps of the epoch (the kernel zeroes the state at each).
    monkeypatch.setattr(compact, "_EPOCHS", 400)
    gen = torch.Generator(device=cuda).manual_seed(3)
    masks = [torch.rand(n, device=cuda, generator=gen) < d
             for n, d in ((200_003, 0.01), (4097, 0.5), (1, 1.0),
                          (50_000, 0.0), (12_289, 1.0))]
    capacity = 3000
    got = [compact.compact_mask(masks[i % len(masks)], capacity)
           for i in range(1000)]
    for i, mask in enumerate(masks):
        want_idx, want_total = compact.compact_mask_plain(mask, capacity)
        idx = torch.stack([g[0] for g in got[i::len(masks)]])
        totals = torch.stack([g[1] for g in got[i::len(masks)]])
        assert torch.equal(idx, want_idx.expand_as(idx))
        assert bool((totals == want_total).all())


def test_compact_kernel_on_two_streams(cuda):
    # Calls queued on a second stream and on the default one at once each
    # take their own stream's state.
    gen = torch.Generator(device=cuda).manual_seed(5)
    mask = torch.rand(1 << 20, device=cuda, generator=gen) < 0.02
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        on_side = [compact.compact_mask(mask, 30_000) for _ in range(50)]
    on_main = [compact.compact_mask(mask, 30_000) for _ in range(50)]
    torch.cuda.synchronize()
    assert (cuda.index or 0, side.cuda_stream) in {
        (d, s) for d, s in compact._STATES}
    for got in on_side + on_main:
        _check_compact(mask, 30_000, got)


@pytest.mark.parametrize("scene", SCENES)
def test_collide_on_card_matches_cpu(cuda, scene):
    n, r_max, seed, gx = scene
    coords, radii = _scene(n, r_max, seed)
    for capacity in (0, 4096):
        want = collide(coords, radii, capacity, method="slab", gx=gx)
        got = collide(coords.to(cuda), radii.to(cuda), capacity,
                      method="slab", gx=gx)
        assert bool(got.ok) == bool(want.ok)
        assert int(got.count) == int(want.count)
        if capacity:
            assert torch.equal(got.pairs.cpu(), want.pairs)


COLUMN_SCENES = [
    # n, r_max, seed, gxy (None: default config)
    (2000, 1 / np.sqrt(2000), 0, 4),
    (40000, 1 / np.sqrt(40000), 1, 16),   # zbits = 23
    (900, 0.12, 17, 2),                   # windows of up to 3 rows
]


@pytest.mark.parametrize("scene", COLUMN_SCENES + [
    # The masks' cull at its edges (testing/scenes.py): boxes touching
    # across column faces and a ulp across; radii of half a column; a full
    # column beside an empty one; chunks that end inside either mask word.
    (name, None, None, None) for name in CULL_COLUMN_SCENES])
def test_column_kernels_match_plain(cuda, scene):
    n, r_max, seed, gxy = scene
    cap = None
    if isinstance(n, str):
        coords, radii, gxy, cap = CULL_COLUMN_SCENES[n]()
        coords, radii = torch.from_numpy(coords), torch.from_numpy(radii)
    else:
        coords, radii = _scene(n, r_max, seed)
    gxy, default_cap, rows = columns.default_column_config(
        coords.shape[0], gxy=gxy)
    plan = columns.plan_columns(coords.to(cuda), radii.to(cuda), gxy,
                                cap or default_cap, rows)
    assert bool(plan.ok)
    if n == "mid_word_chunks":
        occ = plan.starts[1:gxy * gxy + 1] - plan.starts[:gxy * gxy]
        ends = set((occ % 64).tolist())
        assert ends & set(range(1, 32)) and ends & set(range(33, 64))
    clamped = False
    for rpw in sorted({1, int(plan.rows_needed), int(plan.rows_rolled)}):
        # Rolled windows longer than rpw rows are clamped to rpw*128 lanes.
        clamped |= bool((plan.wcap > rpw * 128).any())
        _check_counts(plan, rpw)
        before = _build.LAUNCHES["sweep_masks"]
        assert torch.equal(sweep.sweep_masks(plan, rpw),
                           sweep.sweep_masks_plain(plan, rpw))
        assert _build.LAUNCHES["sweep_masks"] == before + 1
    if n == 900:
        assert clamped
    # Windows that start at odd positions and inside a 64-lane segment
    # (the count kernels walk a window in segments from floor(w/64)*64):
    # the tables shifted by 1 and by 65 lanes, cut at the stream's end.
    npos = plan.stream.shape[0] * 128
    for shift in (1, 65):
        w0 = plan.w0 + shift
        shifted = plan._replace(w0=w0, wcap=torch.minimum(
            plan.wcap, npos - w0).clamp(min=0))
        assert bool((shifted.wcap > 0).any())
        for rpw in (1, int(plan.rows_needed)):
            _check_counts(shifted, rpw)


def _check_counts(plan, rpw):
    """Both column count kernels == sweep_count_plain, one launch each."""
    for rolled, name in ((True, "sweep_count_rolled"),
                         (False, "sweep_count_aligned")):
        before = _build.LAUNCHES[name]
        assert int(sweep.sweep_count(plan, rpw, rolled)) \
            == int(sweep.sweep_count_plain(plan, rpw, rolled))
        assert _build.LAUNCHES[name] == before + 1


def _signed_zeros_and_nans(cuda):
    """The mid-word-chunks scene's column plan, with the x bounds of half
    its spheres +0 or -0 (touching at 0, no pair) and one bound of a tenth
    of them NaN of either sign (no pair)."""
    coords, radii, gxy, cap = CULL_COLUMN_SCENES["mid_word_chunks"]()
    gxy, _, rows = columns.default_column_config(len(coords), gxy=gxy)
    plan = columns.plan_columns(torch.from_numpy(coords).to(cuda),
                                torch.from_numpy(radii).to(cuda), gxy, cap,
                                rows)
    return _zeros_and_nans(plan, len(coords))


def _zeros_and_nans(plan, n):
    """``plan`` with the x bounds of half its n spheres +0 or -0 and one
    bound of a tenth of them NaN of either sign."""
    rng = np.random.RandomState(16)
    stream = plan.stream.clone()
    for p in rng.permutation(n)[: n // 2]:
        r, l = divmod(int(p), 128)
        stream[r, 0, l] = float(rng.choice([-0.0, 0.0]))
        stream[r, 3, l] = float(rng.choice([-0.0, 0.0]))
    for p in rng.permutation(n)[: n // 10]:
        r, l = divmod(int(p), 128)
        stream[r, rng.randint(6), l] = float(rng.choice([np.nan, -np.nan]))
    return plan._replace(stream=stream)


def test_column_masks_signed_zeros_and_nans(cuda):
    # The masks kernel tests by the sign of float differences: signed
    # zeros and NaNs must give the plain version's words.
    plan = _signed_zeros_and_nans(cuda)
    for rpw in (1, 2):
        got = sweep.sweep_masks(plan, rpw)
        want = sweep.sweep_masks_plain(plan, rpw)
        assert torch.equal(got, want) and int(want.ne(0).sum()) > 0


def test_column_counts_signed_zeros_and_nans(cuda):
    # The count kernels test by the same sign bits: the plain count,
    # rolled and aligned.
    plan = _signed_zeros_and_nans(cuda)
    for rpw in (1, 2):
        for rolled in (True, False):
            want = int(sweep.sweep_count_plain(plan, rpw, rolled))
            assert int(sweep.sweep_count(plan, rpw, rolled)) == want > 0


@pytest.mark.parametrize("base", [1, 2])
def test_sweep_count_dual_on_card_matches_cpu(cuda, base):
    # The hetero engine's column S-S count on a power-law scene's parked
    # plan: the rolled kernel at ``base`` rows on windows clamped to
    # base*128 lanes (some longer: the residual jobs take the rest).
    coords, radii = _power_law(6000)
    parked = hetero._split(coords, radii, 128)[2]
    config = columns.default_column_config(6000, gxy=3)
    plan = columns.plan_columns(coords, parked, *config)
    assert int((plan.wcap > base * 128).sum()) > 0
    want, want_ok = sweep.sweep_count_dual(plan, base=base)
    before = _build.LAUNCHES["sweep_count_rolled"]
    got, got_ok = sweep.sweep_count_dual(
        columns.plan_columns(coords.to(cuda), parked.to(cuda), *config),
        base=base)
    assert _build.LAUNCHES["sweep_count_rolled"] == before + 1
    assert int(got) == int(want) > 0 and bool(got_ok) == bool(want_ok)


@pytest.mark.parametrize("scene", COLUMN_SCENES)
def test_column_collide_on_card_matches_cpu(cuda, scene):
    n, r_max, seed, gxy = scene
    coords, radii = _scene(n, r_max, seed)
    for method, knobs in (("column", {"gxy": gxy}), ("auto", {})):
        for capacity in (0, 4096):
            want = collide(coords, radii, capacity, method=method, **knobs)
            got = collide(coords.to(cuda), radii.to(cuda), capacity,
                          method=method, **knobs)
            assert bool(got.ok) == bool(want.ok)
            assert int(got.count) == int(want.count)
            if capacity:
                assert torch.equal(got.pairs.cpu(), want.pairs)


def _power_law(n=1500, seed=0):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.35).astype("float32")
    return torch.from_numpy(coords), torch.from_numpy(radii)


def _word_cut(bigs, stream):
    """A capacity that ends inside a mask word: half way into the first
    (row, visited chunk, word), in the emission order, that has two pairs
    or more and starts at a third of the total or later."""
    c0, c1, n_always = bigpass._row_ranges(stream, bigs[1], bigs[2])
    m = bigpass._tile_hits_plain(bigs[0], c0, c1, n_always, stream, 0,
                                 stream.shape[0])
    per_word = m.view(*m.shape[:2], 2, 32, -1).sum((3, 4)).reshape(-1)
    start = torch.cumsum(per_word, 0) - per_word
    w = int(torch.nonzero((per_word >= 2)
                          & (start >= int(per_word.sum()) // 3))[0])
    return int(start[w]) + int(per_word[w]) // 2


@pytest.mark.parametrize("engine", ["column", "slab", "touching",
                                    "zero_rows"])
def test_big_kernels_match_plain(cuda, engine):
    # "touching": bigs on the faces of the rows' union boxes, a row of pad
    # lanes only and a row of parked lanes (testing/scenes.py).
    # "zero_rows": its rows with pairs, each followed by a copy moved 4 in
    # x, whose live lanes visit the same chunks and meet no big.
    if engine in ("touching", "zero_rows"):
        *table, stream = touching_big_pass()
        if engine == "zero_rows":
            far = stream.copy()
            far[:, [0, 3]] += np.float32(4)
            stream = np.stack([stream, far], 1).reshape(-1, *stream.shape[1:])
        bigs = tuple(torch.from_numpy(a).to(cuda) for a in table)
        stream = torch.from_numpy(stream).to(cuda)
    else:
        coords, radii = _power_law()
        nb, bidx, parked, bigs = hetero._split(coords.to(cuda),
                                               radii.to(cuda), 128)
        n = coords.shape[0]
        if engine == "column":
            plan = columns.plan_columns(coords.to(cuda), parked,
                                        *columns.default_column_config(n))
        else:
            plan = slabs.plan_slabs(coords.to(cuda), parked,
                                    *slabs.default_slab_config(n))
        stream = plan.stream
    before = dict(_build.LAUNCHES)
    tot, ok = bigpass.big_count_only(bigs, stream)
    ptot, pok = bigpass.big_count_only_plain(bigs, stream)
    assert int(tot) == int(ptot) > 0 and bool(ok) == bool(pok)
    # The row counts that big_pairs scans for its bases.
    rows = torch.empty((stream.shape[0],), dtype=torch.int32, device=cuda)
    c0, c1, n_always = bigpass.count_launch(bigs, stream, rows, None)
    want_rows = bigpass._tile_hits_plain(bigs[0], c0, c1, n_always, stream,
                                         0, stream.shape[0]).sum((1, 2, 3))
    assert torch.equal(rows.long(), want_rows)
    if engine == "zero_rows":
        assert want_rows[1::2].eq(0).all() and want_rows[0::2].gt(0).sum() > 1
    cut = _word_cut(bigs, stream)
    for capacity in (int(tot) + 100, int(tot) // 2 + 1, 1, cut):
        got = bigpass.big_pairs(bigs, stream, capacity)
        want = bigpass.big_pairs_plain(bigs, stream, capacity)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert _build.LAUNCHES["big_count"] == before["big_count"] + 1
    assert _build.LAUNCHES["big_pairs"] == before["big_pairs"] + 4


def _slab_plan(name, cuda):
    coords, radii, gx, cap = CULL_SLAB_SCENES[name]()
    gx, default_cap, rows = slabs.default_slab_config(len(coords), gx=gx)
    plan = slabs.plan_slabs(torch.from_numpy(coords).to(cuda),
                            torch.from_numpy(radii).to(cuda), gx,
                            cap or default_cap, rows)
    assert bool(plan.ok)
    return plan, len(coords)


def _check_slab_kernels(plan, rpws=(1, 2)):
    """The slab count kernel at first_off 0 and 1, dmin 0 and 48, and the
    slab masks kernel, at each of ``rpws`` rolled rows, == their plain
    versions, one launch each. Returns the masks' nonzero words."""
    args = (plan.stream, plan.starts, plan.w0, plan.wcap)
    words = 0
    for rpw in rpws:
        for first_off in (0, 1):
            for dmin in (0, 48):
                kw = {"rpw": rpw, "first_off": first_off, "dmin": dmin}
                before = _build.LAUNCHES["slab_count"]
                assert int(slab_sweep.slab_window_count(*args, **kw)) \
                    == int(slab_sweep.slab_window_count_plain(*args, **kw))
                assert _build.LAUNCHES["slab_count"] == before + 1
        before = _build.LAUNCHES["slab_masks"]
        got = slab_sweep.slab_masks(*args, rpw=rpw)
        assert _build.LAUNCHES["slab_masks"] == before + 1
        assert torch.equal(got, slab_sweep.slab_masks_plain(*args, rpw=rpw))
        words += int(got.ne(0).sum())
    return words


@pytest.mark.parametrize("name", sorted(CULL_SLAB_SCENES))
def test_slab_kernels_match_plain_on_cull_edges(cuda, name):
    # The slab kernels' cull at its edges (testing/scenes.py): boxes
    # touching across slab faces and a ulp across, chunks that end inside
    # either mask word, windows from odd positions and from a stream
    # row's last lane, a slab beside an empty one, windows past 128 lanes.
    plan, _ = _slab_plan(name, cuda)
    assert SLAB_EDGES[name] <= slab_edges(
        *(t.cpu().numpy() for t in (plan.stream, plan.starts, plan.w0,
                                    plan.wcap)), plan.gx)
    assert _check_slab_kernels(plan) > 0
    # Windows shifted by 1 and by 65 lanes (odd starts; starts inside a
    # 64-lane segment of the count's walk), cut at the stream's end.
    npos = plan.stream.shape[0] * 128
    for shift in (1, 65):
        w0 = plan.w0 + shift
        shifted = plan._replace(w0=w0, wcap=torch.minimum(
            plan.wcap, npos - w0).clamp(min=0))
        assert bool((shifted.wcap > 0).any())
        _check_slab_kernels(shifted)


def test_slab_kernels_signed_zeros_and_nans(cuda):
    # The slab kernels test by the sign bits of float differences, as the
    # column kernels do: signed zeros and NaNs must give the plain
    # version's counts and words.
    plan = _zeros_and_nans(*_slab_plan("mid_word_slabs", cuda))
    assert _check_slab_kernels(plan) > 0


def test_slab_kernels_at_two_rows_match_plain(cuda):
    coords, radii = _scene(900, 0.12, 17)
    plan = slabs.plan_slabs(coords.to(cuda), radii.to(cuda),
                            *slabs.default_slab_config(900, gx=1))
    args = (plan.stream, plan.starts, plan.w0, plan.wcap)
    assert int(slab_sweep.slab_window_count(*args, rpw=2)) \
        == int(slab_sweep.slab_window_count_plain(*args, rpw=2))
    assert torch.equal(slab_sweep.slab_masks(*args, rpw=2),
                       slab_sweep.slab_masks_plain(*args, rpw=2))


@pytest.mark.parametrize("engine,rpw", [("column", 2), ("slab", 1)])
def test_hetero_on_card_matches_cpu(cuda, engine, rpw):
    coords, radii = _power_law()
    for capacity in (0, 4096, 1000):
        want = hetero.hetero_collide(coords, radii, capacity, nb=128,
                                     rpw=rpw, engine=engine)
        got = hetero.hetero_collide(coords.to(cuda), radii.to(cuda),
                                    capacity, nb=128, rpw=rpw, engine=engine)
        assert bool(got[2]) == bool(want[2]) and bool(got[2])
        assert int(got[1]) == int(want[1])
        if capacity:
            assert torch.equal(got[0].cpu(), want[0])
    res = collide(coords.to(cuda), radii.to(cuda), 4096, method="hetero")
    ref = collide(coords, radii, 4096, method="hetero")
    assert bool(res.ok) == bool(ref.ok)
    assert torch.equal(res.pairs.cpu(), ref.pairs)


def _emit_inputs(engine, device):
    """(B, wstart_tab, cb_tab, ids) of the windows-past-128-lanes scene
    at the rows-per-window rung its windows need: aligned column rows or
    rolled slab rows. ``ids`` stops at the last sphere, without the
    stream's pad lanes."""
    coords, radii = _scene(900, 0.12, 17)
    if engine == "column":
        plan = columns.plan_columns(coords.to(device), radii.to(device),
                                    *columns.default_column_config(900, gxy=2))
        rpw = int(plan.rows_needed)
        B = sweep.sweep_masks(plan, rpw)
    else:
        plan = slabs.plan_slabs(coords.to(device), radii.to(device),
                                *slabs.default_slab_config(900, gx=2))
        rpw = int(plan.rows_rolled)
        B = slab_sweep.slab_sweep_masks(plan, rpw)
    ws, cb = fill._emit_tables(B, plan.starts.long(), plan.w0.reshape(-1).long(),
                               plan.mc, 5 if engine == "column" else 2, rpw,
                               rolled=engine == "slab")
    return B, ws, cb, fill._sorted_ids(plan)[:900]


@pytest.mark.parametrize("engine", ["column", "slab"])
def test_pair_emit_kernel_matches_plain(cuda, engine):
    B, ws, cb, ids = _emit_inputs(engine, cuda)
    if engine == "slab":
        # The last windows' rows run past the end of the stream.
        assert int(ws.max()) + 128 > ids.numel()
    rp = pair_emit.row_popcounts(B)
    cum = torch.cumsum(rp, 0)
    total = int(cum[-1])
    row = int(torch.nonzero(rp > 1)[len(rp) // 100])
    capacities = (total + 100,           # room for every pair
                  int(cum[row]) - 1,     # a cut inside one row
                  int(cum[row - 1]))     # rows from `row` on start past it
    before = _build.LAUNCHES["pair_emit"]
    for capacity in capacities:
        got = pair_emit.emit_pairs(B, ws, cb, ids, capacity)
        want = pair_emit.emit_pairs_plain(B, ws, cb, ids, capacity)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.LAUNCHES["pair_emit"] == before + len(capacities)


def _rows_of_every_width():
    """(B, wstart_tab, cb_tab, ids): mask rows of 0, 1, ..., 4096 set bits
    (and one more empty row), bits at random places, tables that reach
    past both ends of the ids (the clamps), ids past 2^31."""
    rng = np.random.RandomState(11)
    rows = 4098
    width = np.minimum(np.arange(rows), 4096)
    width[-1] = 0
    bits = rng.random((rows, 4096)).argsort(axis=1) < width[:, None]
    B = np.packbits(bits, axis=1, bitorder="little").view("<u4").view(np.int32)
    nsort = 6000
    ws = rng.randint(-200, nsort + 200, (1, rows // 2))
    cb = rng.randint(-100, nsort + 100, (1, rows // 2))
    ids = rng.randint(0, 1 << 32, nsort, dtype=np.uint64).astype(np.int64)
    return (torch.from_numpy(B.reshape(1, rows, 128).copy()),
            torch.from_numpy(ws), torch.from_numpy(cb), torch.from_numpy(ids))


def test_pair_emit_kernel_rows_of_every_width(cuda):
    B, ws, cb, ids = (t.to(cuda) for t in _rows_of_every_width())
    rp = pair_emit.row_popcounts(B)
    assert torch.equal(rp, pair_emit.row_popcounts_plain(B))
    assert rp[:4097].tolist() == list(range(4097))
    cum = torch.cumsum(rp, 0)
    total = int(cum[-1])
    full = int(cum[4095])             # the row of 4096 bits starts here
    capacities = (total + 101,        # room for every pair, odd sentinels
                  full + 2049,        # a cut in the middle of the full row
                  full + 1, 0, 1, 2, 3)
    before = dict(_build.LAUNCHES)
    for capacity in capacities:
        want = pair_emit.emit_pairs_plain(B, ws, cb, ids, capacity, rp)
        for rp_tab in (None, rp):
            got = pair_emit.emit_pairs(B, ws, cb, ids, capacity, rp_tab)
            assert got[0].dtype == got[1].dtype == torch.int64
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # No launch at capacity 0; the row counts only where none are given.
    assert _build.LAUNCHES["pair_emit"] == before["pair_emit"] \
        + 2 * (len(capacities) - 1)
    assert _build.LAUNCHES["row_popcounts"] == before["row_popcounts"] \
        + len(capacities) - 1


def test_row_popcounts_on_the_dense_exact_plan(cuda):
    # The reference's dense scene at its exact column route: 0.87 GB of
    # masks.
    rng = np.random.RandomState(4)
    n = 307_200
    coords = torch.from_numpy(rng.random((n, 3)).astype("float32")).to(cuda)
    radii = torch.from_numpy(
        rng.uniform(0, 0.06, n).astype("float32")).to(cuda)
    plan = columns.plan_columns(coords, radii, 14, 4608, 295)
    B = sweep.sweep_masks(plan, 12)
    rp = pair_emit.row_popcounts(B)
    assert torch.equal(rp, pair_emit.row_popcounts_plain(B))
    assert int(rp.sum()) == 107_651_273


def test_sweep_masks_on_the_dense_exact_plan(cuda):
    # The same plan: every word of the culled kernel's 0.87 GB of masks
    # against the plain version's.
    rng = np.random.RandomState(4)
    n = 307_200
    coords = torch.from_numpy(rng.random((n, 3)).astype("float32")).to(cuda)
    radii = torch.from_numpy(
        rng.uniform(0, 0.06, n).astype("float32")).to(cuda)
    plan = columns.plan_columns(coords, radii, 14, 4608, 295)
    assert bool(plan.ok) and int(plan.rows_needed) <= 12
    before = _build.LAUNCHES["sweep_masks"]
    B = sweep.sweep_masks(plan, 12)
    assert _build.LAUNCHES["sweep_masks"] == before + 1
    assert torch.equal(B, sweep.sweep_masks_plain(plan, 12))


def test_collider_on_card_matches_cpu(cuda):
    # Mixed radii on the column engine: the first step is not ok, and the
    # hetero retry ladder runs.
    rng = np.random.RandomState(0)
    coords = rng.random((1500, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, 1500))).clip(0, 0.35).astype("float32")
    for capacity in (0, 8192):
        want = Collider(1500, method="column", device="cpu").get_collisions(
            coords, radii, capacity)
        got = Collider(1500, method="column").get_collisions(
            coords, radii, capacity)
        if capacity:
            assert torch.equal(got[1].cpu(), want[1])
            got, want = got[0], want[0]
        assert int(got) == int(want) > 0
    res = collide_exact(torch.from_numpy(coords).to(cuda),
                        torch.from_numpy(radii).to(cuda), fill.BIG_FILL_THRESHOLD + 8,
                        method="column")
    assert bool(res.ok) and res.pairs.is_cuda and int(res.count) == int(want)


GRID_SCENES = [
    # n, radius scale (radii U(0, scale/sqrt(n))), grid_dim, cell_capacity
    (3000, 1.5, 6, 48),
    (3000, 1.5, 5, 64),      # odd grid_dim: no batched count
    (2400, 1.5, 2, 400),     # ~300 spheres a cell: three 128-row chunks
    # The cull's edges (testing/scenes.py), at their own grid_dim and
    # cell_capacity: boxes touching across cell faces and a ulp across;
    # radii of half a cell; a 305-row cell beside an empty one.
    ("touching_lattice", None, None, None),
    ("half_cell_radii", None, None, None),
    ("full_cell_beside_empty", None, None, None),
]


def _grid_scene(n, rscale):
    return _scene(n, rscale / np.sqrt(n), n)


@pytest.mark.parametrize("scene", GRID_SCENES)
def test_grid_kernels_match_plain(cuda, scene):
    n, rscale, gd, mc = scene
    if isinstance(n, str):
        coords, radii, gd, mc = CULL_GRID_SCENES[n]()
        coords, radii = torch.from_numpy(coords), torch.from_numpy(radii)
    else:
        coords, radii = _grid_scene(n, rscale)
    bins, ok, _ = grid.build_grid(coords.to(cuda), radii.to(cuda), gd, mc)
    assert bool(ok)
    before = dict(_build.LAUNCHES)
    tc = emit.halo_tile_counts(bins, gd, mc)
    assert torch.equal(tc, emit.halo_tile_counts_plain(bins, gd, mc))
    flat = tc.reshape(-1)
    total = int(flat.sum())
    assert total > 0
    _, count = halo.halo_pairs(bins, gd, mc, 0)
    assert int(count) == total == int(halo.halo_pairs_plain(bins, gd, mc, 0)[1])
    if gd % 2 == 0:
        assert int(batched.batched_count(bins, gd, mc)) == total \
            == int(batched.batched_count_plain(bins, gd, mc))
    # A cut inside the first tile with two pairs or more, and one slot.
    t = int(torch.nonzero(flat >= 2)[0])
    cut = int(flat[:t].sum()) + 1
    bases = torch.cumsum(flat, 0) - flat
    tiles = torch.nonzero(flat).flatten()
    for capacity in (total + 100, cut, 1):
        want, want_total = halo.halo_pairs_plain(bins, gd, mc, capacity)
        got, got_total = halo.halo_pairs(bins, gd, mc, capacity)
        assert torch.equal(got, want) and int(got_total) == int(want_total) == total
        fill, fill_total = emit.grid_fill(bins, gd, mc, capacity)
        assert torch.equal(fill, want) and int(fill_total) == total
        args = (bins, tiles, bases[tiles], gd, mc, capacity)
        assert torch.equal(emit.emit_pairs(*args), emit.emit_pairs_plain(*args))
    assert bool((want != 0xFFFFFFFF).all())    # the one slot is written
    # halo_pairs with a capacity is grid_fill: tile counts, hit tiles, emission.
    runs = {"grid_tile_counts": 7, "halo_count": 1, "grid_emit": 9,
            "compact_mask": 6, "batched_count": int(gd % 2 == 0)}
    for name, k in runs.items():
        assert _build.LAUNCHES[name] == before[name] + k, name


@pytest.mark.parametrize("knobs", [{}, {"grid_dim": 5, "cell_capacity": 64},
                                   {"cell_capacity": 16}])
def test_grid_collide_on_card_matches_cpu(cuda, knobs):
    coords, radii = _grid_scene(3000, 1.5)
    for capacity in (0, 4096, 100):
        want = collide(coords, radii, capacity, method="grid", **knobs)
        got = collide(coords.to(cuda), radii.to(cuda), capacity, method="grid",
                      **knobs)
        assert bool(got.ok) == bool(want.ok) == ("cell_capacity" not in knobs
                                                 or knobs["cell_capacity"] > 16)
        assert int(got.count) == int(want.count)
        if capacity:
            assert torch.equal(got.pairs.cpu(), want.pairs)


@pytest.mark.parametrize("grid_dim", [24, 25])
def test_build_grid_on_card_matches_cpu(cuda, grid_dim):
    # At 1M spheres the cell size divides by grid_dim on the card: a
    # division by a Python number there would bin by its reciprocal.
    coords, radii = _scene(1_000_000, 1 / np.sqrt(1_000_000), 4)
    want = grid.build_grid(coords, radii, grid_dim, 120)
    got = grid.build_grid(coords.to(cuda), radii.to(cuda), grid_dim, 120)
    assert bool(got[1]) == bool(want[1]) and bool(want[1])
    assert torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[2].cpu(), want[2])


def _diag_scene(kind):
    """The uniform parity scene, or every sphere at one z (partners at any
    sorted distance: the detector must flag)."""
    if kind == "uniform":
        return _scene(2048, 2 / np.sqrt(2048), 26)
    coords, _ = _scene(400, 0.003, 28)
    coords[:, 2] = 0.5
    return coords, torch.full((400,), 0.003)


@pytest.mark.parametrize("kind", ["uniform", "same_z"])
def test_diag_kernel_matches_plain(cuda, kind):
    coords, radii = _diag_scene(kind)
    config = slabs.default_slab_config(coords.shape[0])
    plan = slabs.plan_slabs(coords.to(cuda), radii.to(cuda), *config)
    cpu_plan = slabs.plan_slabs(coords, radii, *config)
    assert torch.equal(plan.diag_thr.cpu().view(torch.int32),
                       cpu_plan.diag_thr.view(torch.int32))
    before = _build.LAUNCHES["diag_count"]
    # 3000: the staged boxes pass 48 KB of shared memory.
    d_maxes = (0, 4, 16, 48, 130, 3000)
    for d_max in d_maxes:
        got = slab_sweep.diag_count(plan.stream, plan.diag_thr, d_max)
        want = slab_sweep.diag_count_plain(plan.stream, plan.diag_thr, d_max)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
        if kind == "same_z" and d_max == 16:
            assert int(got[1]) > 0
    assert _build.LAUNCHES["diag_count"] == before + len(d_maxes)
    with pytest.raises(ValueError, match="d_max"):
        slab_sweep.diag_count(plan.stream, plan.diag_thr, 32 * 128)


@pytest.mark.parametrize("scene,d_max", [((317, 1 / np.sqrt(317), 23), 48),
                                         ((2048, 2 / np.sqrt(2048), 26), 130)])
def test_slab_count_diag_on_card_matches_oracle(cuda, scene, d_max):
    from collision_tpu_torch.testing import brute_force_collisions

    coords, radii = _scene(*scene)
    config = slabs.default_slab_config(scene[0])
    plan = slabs.plan_slabs(coords.to(cuda), radii.to(cuda), *config)
    before = dict(_build.LAUNCHES)
    count, ok = slab_sweep.slab_count_diag(plan, d_max)
    assert bool(plan.ok) and bool(ok)
    assert int(count) == len(brute_force_collisions(coords.numpy(),
                                                    radii.numpy()))
    assert _build.LAUNCHES["diag_count"] == before["diag_count"] + 1
    assert _build.LAUNCHES["slab_count"] == before["slab_count"] + 1
    want = slab_sweep.slab_count_diag(
        slabs.plan_slabs(coords, radii, *config), d_max)
    assert int(want[0]) == int(count) and bool(want[1])


@pytest.mark.parametrize("method", ["column", "auto", "grid"])
def test_float64_collide_on_card_matches_oracle(cuda, method):
    from collision_tpu_torch.testing import (brute_force_collisions,
                                             pair_array_to_set)

    rng = np.random.RandomState(9)
    coords = torch.from_numpy(rng.random((3000, 3)))
    radii = torch.from_numpy(rng.uniform(0, 1.5 / np.sqrt(3000), 3000))
    expected = brute_force_collisions(coords.numpy(), radii.numpy())
    for capacity in (0, len(expected) + 8, len(expected) // 2):
        got = collide(coords.to(cuda), radii.to(cuda), capacity,
                      method=method, cand_capacity=1 << 20)
        want = collide(coords, radii, capacity, method=method,
                       cand_capacity=1 << 20)
        assert bool(got.ok) and bool(want.ok)
        assert int(got.count) == int(want.count) == len(expected)
        if capacity:
            assert torch.equal(got.pairs.cpu(), want.pairs)
            assert pair_array_to_set(got.pairs.cpu(), min(
                capacity, len(expected))) <= expected


def test_float64_collider_retries_on_card(cuda):
    # 1000 spheres at one point: 499,500 pairs past the default 2^17
    # candidates, so the run-expansion retry provisions the bound.
    coords = np.zeros((1000, 3))
    radii = np.full(1000, 0.1)
    assert not bool(collide(torch.from_numpy(coords).to(cuda),
                            torch.from_numpy(radii).to(cuda), 1000).ok)
    count, pairs = Collider(1000, coord_dtype="float64").get_collisions(
        coords, radii, 1000)
    want = Collider(1000, coord_dtype="float64",
                    device="cpu").get_collisions(coords, radii, 1000)
    assert int(count) == int(want[0]) == 499_500
    assert torch.equal(pairs.cpu(), want[1])


@pytest.mark.parametrize("name", ["clustered_blobs", "power_law_radii",
                                  "lattice_touching", "lattice_nudged",
                                  "huge_magnitudes", "planar", "collinear",
                                  "many_duplicates", "fuzz_0", "fuzz_1",
                                  "fuzz_2", "fuzz_3"])
def test_adversarial_scene_on_card(cuda, name):
    from test_torch_adversarial import SCENES, check_engines

    coords, radii, grid_dim = SCENES[name]()
    check_engines(coords, radii, grid_dim, cuda)
