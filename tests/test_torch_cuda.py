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


@pytest.mark.parametrize("scene", COLUMN_SCENES)
def test_column_kernels_match_plain(cuda, scene):
    n, r_max, seed, gxy = scene
    coords, radii = _scene(n, r_max, seed)
    gxy, cap, rows = columns.default_column_config(n, gxy=gxy)
    plan = columns.plan_columns(coords.to(cuda), radii.to(cuda), gxy, cap,
                                rows)
    for rpw in (1, int(plan.rows_needed)):
        for rolled, name in ((True, "sweep_count_rolled"),
                             (False, "sweep_count_aligned")):
            before = _build.LAUNCHES[name]
            assert int(sweep.sweep_count(plan, rpw, rolled)) \
                == int(sweep.sweep_count_plain(plan, rpw, rolled))
            assert _build.LAUNCHES[name] == before + 1
        before = _build.LAUNCHES["sweep_masks"]
        assert torch.equal(sweep.sweep_masks(plan, rpw),
                           sweep.sweep_masks_plain(plan, rpw))
        assert _build.LAUNCHES["sweep_masks"] == before + 1


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


@pytest.mark.parametrize("engine", ["column", "slab"])
def test_big_kernels_match_plain(cuda, engine):
    coords, radii = _power_law()
    nb, bidx, parked, bigs = hetero._split(coords.to(cuda), radii.to(cuda),
                                           128)
    n = coords.shape[0]
    if engine == "column":
        plan = columns.plan_columns(coords.to(cuda), parked,
                                    *columns.default_column_config(n))
    else:
        plan = slabs.plan_slabs(coords.to(cuda), parked,
                                *slabs.default_slab_config(n))
    before = dict(_build.LAUNCHES)
    tot, ok = bigpass.big_count_only(bigs, plan.stream)
    ptot, pok = bigpass.big_count_only_plain(bigs, plan.stream)
    assert int(tot) == int(ptot) > 0 and bool(ok) == bool(pok)
    for capacity in (int(tot) + 100, int(tot) // 2 + 1, 1):
        got = bigpass.big_pairs(bigs, plan.stream, capacity)
        want = bigpass.big_pairs_plain(bigs, plan.stream, capacity)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert _build.LAUNCHES["big_count"] == before["big_count"] + 1
    assert _build.LAUNCHES["big_pairs"] == before["big_pairs"] + 3


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
]


def _grid_scene(n, rscale):
    return _scene(n, rscale / np.sqrt(n), n)


@pytest.mark.parametrize("scene", GRID_SCENES)
def test_grid_kernels_match_plain(cuda, scene):
    n, rscale, gd, mc = scene
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
