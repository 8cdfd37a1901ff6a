"""The CUDA kernels of collision_tpu_torch against their plain PyTorch
versions, and ``collide`` on the card against ``collide`` on the CPU.

Needs an NVIDIA GPU and the CUDA toolkit: every test skips without a
card. Imports no JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from collision_tpu_torch import collide, columns, slabs
from collision_tpu_torch.kernels import _build, compact, slab_sweep, sweep

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
    assert int(slab_sweep.slab_count(*args)) \
        == int(slab_sweep.slab_count_plain(*args))
    assert torch.equal(slab_sweep.slab_masks(*args),
                       slab_sweep.slab_masks_plain(*args))
    assert _build.LAUNCHES["slab_count"] == before["slab_count"] + 1
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
