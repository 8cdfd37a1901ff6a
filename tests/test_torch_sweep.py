"""Port parity: the column sweep kernels' plain versions against the JAX
Pallas kernels (in interpret mode), on one column plan carried across
with ``columns.plan_from_numpy``. Integer outputs: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import columns as jcolumns
from collision_tpu.kernels import sweep as jsweep
from collision_tpu_torch import columns
from collision_tpu_torch.kernels import sweep
from collision_tpu_torch.testing import brute_force_collisions
from collision_tpu_torch.testing.scenes import COLUMN_SCENES

SCENES = {
    # n, r_max, seed, gxy
    "uniform": (2000, 1 / np.sqrt(2000), 0, 4),
    "wide": (900, 0.12, 17, 2),      # windows past 128 lanes, 3 rows
}

# (scene, rpw): rpw 1 leaves rows out on both scenes; the kernels must
# still agree on what they test.
CASES = [("uniform", 1), ("uniform", 2), ("wide", 8)]


def _plans(name):
    """Numpy scene, JAX plan and port plan of a scene of SCENES or of
    the column masks' cull edges (testing/scenes.py)."""
    if name in COLUMN_SCENES:
        coords, radii, gxy, cap = COLUMN_SCENES[name]()
        n = len(coords)
    else:
        n, r_max, seed, gxy = SCENES[name]
        rng = np.random.RandomState(seed)
        coords = rng.random((n, 3)).astype("float32")
        radii = rng.uniform(0, r_max, n).astype("float32")
        cap = None
    gxy, default_cap, rows = columns.default_column_config(n, gxy=gxy)
    cap = cap or default_cap
    jp = jcolumns.plan_columns(jnp.asarray(coords), jnp.asarray(radii), gxy,
                               cap, rows)
    d = {k: np.asarray(v) if hasattr(v, "shape") else v
         for k, v in jp._asdict().items()}
    return coords, radii, jp, columns.plan_from_numpy(d, "cpu")


@pytest.mark.parametrize("rolled", [True, False])
@pytest.mark.parametrize("scene,rpw", CASES)
def test_sweep_count_plain_matches_pallas(scene, rpw, rolled):
    coords, radii, jp, tp = _plans(scene)
    # unroll=1: the TPU's chunk unrolling changes no count of an ok plan
    # and would only lengthen the interpreter's trace.
    want, _ = jsweep._sweep_count(
        jp.stream, jp.starts, jp.slab_r0, jp.w0, jp.wcap, jp.gxy, jp.mc,
        jp.slab_rows, rpw, interpret=True, rolled=rolled, unroll=1)
    got, no_wrap = sweep.sweep_count_guarded(tp, rpw=rpw, rolled=rolled)
    assert got.dtype == torch.int64 and bool(no_wrap)
    assert int(got) == int(want)
    if bool(tp.ok) and int(tp.rows_rolled if rolled else tp.rows_needed) <= rpw:
        assert int(got) == len(brute_force_collisions(coords, radii))
    else:
        assert int(got) < len(brute_force_collisions(coords, radii))


# The masks also at the edges of the card kernel's cull: boxes touching
# across column faces and a ulp across, and a full column beside an
# empty one.
@pytest.mark.parametrize("scene,rpw", CASES + [
    ("touching_lattice", 2), ("full_column_beside_empty", 1)])
def test_sweep_masks_plain_matches_pallas(scene, rpw):
    _, _, jp, tp = _plans(scene)
    want = np.asarray(jsweep.sweep_masks(jp, rpw=rpw, interpret=True))
    got = sweep.sweep_masks(tp, rpw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)

