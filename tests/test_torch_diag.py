"""Port parity: the diagonal count (kernel 4) and its plan-level callers
against the JAX package, with its Pallas kernels in interpret mode.

The port's plain versions run on plans carried across from JAX with
``plan_from_numpy``, so both sides count on identical inputs. Counts and
flags are integers: equality is exact. ``diag_thr`` of the port's own
plan must equal JAX's bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import slabs as jslabs
from collision_tpu.kernels import slab_sweep as jsweep
from collision_tpu_torch import slabs
from collision_tpu_torch.kernels import slab_sweep
from collision_tpu_torch.kernels.sweep import RPW_LADDER
from collision_tpu_torch.testing import brute_force_collisions


def _scene(n, rscale, seed, same_z=False):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype("float32")
    if same_z:
        coords[:, 2] = 0.5
        radii = np.full(n, 0.003, dtype="float32")
    return coords, radii


def _plans(coords, radii, gx=None):
    """(JAX plan, the port's own plan, the port's copy of the JAX plan)."""
    gx, cap, rows = slabs.default_slab_config(len(coords), gx=gx)
    jp = jslabs.plan_slabs(jnp.asarray(coords), jnp.asarray(radii), gx, cap,
                           rows)
    tp = slabs.plan_slabs(torch.from_numpy(coords), torch.from_numpy(radii),
                          gx, cap, rows)
    d = {k: np.asarray(v) if hasattr(v, "shape") else v
         for k, v in jp._asdict().items()}
    return jp, tp, slabs.plan_from_numpy(d, "cpu")


@pytest.mark.parametrize("n,rscale,seed,gx", [
    (2000, 1.0, 0, None),
    (900, 1.5, 25, 2),
    (20000, 1.0, 1, 300),    # gx >= 255: zscale is an IEEE division
])
def test_diag_thr_bit_equal(n, rscale, seed, gx):
    jp, tp, _ = _plans(*_scene(n, rscale, seed), gx=gx)
    assert tp.diag_thr.dtype == torch.float32 and tp.diag_thr.shape == (1,)
    np.testing.assert_array_equal(tp.diag_thr.numpy().view(np.uint32),
                                  np.asarray(jp.diag_thr).view(np.uint32))


@pytest.mark.parametrize("n,rscale,seed,d_max", [
    (317, 1.0, 23, 48),
    (1000, 0.5, 24, 48),
    (900, 1.5, 25, 130),   # d_max past one lane row
    (2048, 2.0, 26, 130),  # ~1000 spheres a slab: reach beyond 48
])
def test_slab_count_diag_matches_jax(n, rscale, seed, d_max):
    coords, radii = _scene(n, rscale, seed)
    jp, tp, tq = _plans(coords, radii)
    assert bool(jp.ok) and bool(tp.ok)
    # Positional, as slab_count_diag calls it: one compile serves both.
    jc, _, jflag = jsweep.diag_count(jp.stream, jp.diag_thr, d_max, True)
    tc, tflag = slab_sweep.diag_count(tq.stream, tq.diag_thr, d_max)
    assert tc.dtype == torch.int64 and tflag.dtype == torch.int64
    assert (int(tc), int(tflag)) == (int(jc), int(jflag))
    want, want_ok = jsweep.slab_count_diag(jp, d_max=d_max, interpret=True)
    expected = len(brute_force_collisions(coords, radii))
    for plan in (tq, tp):
        got, ok = slab_sweep.slab_count_diag(plan, d_max=d_max)
        assert bool(ok) == bool(want_ok) and bool(ok)
        assert int(got) == int(want) == expected


def test_slab_count_diag_detector_matches_jax():
    # d_max too small for the scene: the count may fall short only where
    # the detector flags (ok=False), on both sides alike.
    coords, radii = _scene(700, 0.08 * np.sqrt(700), 27)
    jp, _, tq = _plans(coords, radii)
    expected = len(brute_force_collisions(coords, radii))
    oks = []
    for d_max in (4, 16, 130):
        want, want_ok = jsweep.slab_count_diag(jp, d_max=d_max,
                                               interpret=True)
        got, ok = slab_sweep.slab_count_diag(tq, d_max=d_max)
        assert int(got) == int(want) <= expected
        assert bool(ok) == bool(want_ok)
        if int(got) != expected:
            assert not bool(ok)
        oks.append(bool(ok))
    assert oks[0] is False      # 4 positions are far too few here


def test_same_z_cluster_flags():
    # Every sphere at one z: partners sit at any sorted distance, so the
    # detector flags, while the dual dispatch stays exact.
    coords, radii = _scene(400, 0, 28, same_z=True)
    jp, tp, tq = _plans(coords, radii)
    expected = len(brute_force_collisions(coords, radii))
    want, want_ok = jsweep.slab_count_diag(jp, d_max=16, interpret=True)
    _, _, jflag = jsweep.diag_count(jp.stream, jp.diag_thr, 16, True)
    got, ok = slab_sweep.slab_count_diag(tq, d_max=16)
    _, flag = slab_sweep.diag_count(tq.stream, tq.diag_thr, 16)
    assert int(flag) == int(jflag) > 0
    assert not bool(ok) and not bool(want_ok)
    assert int(got) == int(want) <= expected
    dual, dual_ok = slab_sweep.slab_count_dual(tp)
    assert bool(dual_ok) and int(dual) == expected


def test_cross_pass_and_residual_at_dmin_match_jax():
    # The two windowed parts of slab_count_diag on their own, on a scene
    # with windows past 128 lanes, so the residual jobs are live.
    coords, radii = _scene(900, 0.12 * np.sqrt(900), 17)
    jp, _, tq = _plans(coords, radii, gx=2)
    assert int(tq.rows_rolled) >= 2
    for dmin in (0, 48):
        want, _ = jsweep._slab_count(
            jp.stream, jp.starts, jp.slab_r0, jp.w0,
            jnp.minimum(jp.wcap, 128), jp.gx, jp.mc, jp.slab_rows, 1, True,
            offsets=(1,), dmin=dmin)
        got = slab_sweep.slab_window_count(
            tq.stream, tq.starts, tq.w0, torch.clamp_max(tq.wcap, 128),
            rpw=1, first_off=1, dmin=dmin)
        assert int(got) == int(want) > 0
        want_r, want_rok = jslabs.residual_count(jp, 256, dmin=dmin)
        got_r, got_rok = slabs.residual_count(tq, 256, dmin=dmin)
        assert int(got_r) == int(want_r) > 0
        assert bool(got_rok) == bool(want_rok)


def test_plan_level_slab_count_matches_jax():
    coords, radii = _scene(1000, 2.0, 1)
    jp, tp, _ = _plans(coords, radii, gx=5)
    rpw = next(r for r in RPW_LADDER if r >= int(tp.rows_rolled))
    want, want_ok = jsweep.slab_count_guarded(jp, rpw=rpw, interpret=True)
    got, ok = slab_sweep.slab_count_guarded(tp, rpw=rpw)
    assert bool(ok) == bool(want_ok) and bool(ok)
    assert int(got) == int(want) == int(slab_sweep.slab_count(tp, rpw))
    assert int(got) == len(brute_force_collisions(coords, radii))


@pytest.mark.parametrize("d_max", [-1, 32 * 128])
def test_diag_count_rejects_reach_past_the_successor_block(d_max):
    _, tp, _ = _plans(*_scene(300, 1.0, 3))
    with pytest.raises(ValueError, match="d_max"):
        slab_sweep.diag_count(tp.stream, tp.diag_thr, d_max)
