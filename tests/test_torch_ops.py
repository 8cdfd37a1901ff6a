"""Port parity: the plain primitives of collision_tpu_torch against the
JAX package's, on the same numpy inputs. Integer outputs and identical
float32 operations, so equality is exact throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_tpu import columns as jcolumns
from collision_tpu import fill as jfill
from collision_tpu import slabs as jslabs
from collision_tpu.kernels import sweep as jsweep
from collision_tpu.ops import offset as joffset
from collision_tpu.ops import reduce as jreduce
from collision_tpu.ops import scan as jscan
from collision_tpu_torch import columns, slabs
from collision_tpu_torch.kernels import pair_emit, sweep
from collision_tpu_torch.ops import inclusive_scan, scene_bounds, sorted_bucket_starts


@pytest.mark.parametrize("n", [1, 5, 1000, 1027])
def test_scene_bounds(n):
    rng = np.random.RandomState(n)
    coords = (rng.standard_normal((n, 3)) * 10).astype("float32")
    lo, hi = scene_bounds(torch.from_numpy(coords))
    jlo, jhi = jreduce.scene_bounds(jnp.asarray(coords))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("n,nb,hi", [
    (1, 4, 3),          # one value
    (300, 40, 10),      # heavy ties, many empty buckets above the top
    (1000, 257, 5000),  # empty buckets between runs, n not a multiple of 128
    (4099, 999, 2 ** 32 - 2),  # full uint32 range
])
def test_sorted_bucket_starts(n, nb, hi):
    rng = np.random.RandomState(n)
    values = np.sort(rng.randint(0, hi, n, dtype=np.int64)).astype(np.uint32)
    buckets = np.concatenate([
        rng.randint(0, hi, nb - 2, dtype=np.int64), [0, hi]]).astype(np.uint32)
    got = sorted_bucket_starts(torch.from_numpy(values.astype(np.int64)),
                               torch.from_numpy(buckets.astype(np.int64)))
    want = joffset.sorted_bucket_starts(jnp.asarray(values), jnp.asarray(buckets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,hi", [(1, 9), (129, 3), (4096, 1000), (9000, 2 ** 30)])
def test_inclusive_scan_modular_int32(n, hi):
    # n > 4096 takes the JAX package's blocked path; hi = 2^30 wraps int32.
    rng = np.random.RandomState(n)
    v = rng.randint(0, hi, n).astype(np.int32)
    got = inclusive_scan(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jscan.inclusive_scan(jnp.asarray(v))))


@pytest.mark.parametrize("zbits", [23, 25, 31])
def test_quantize_clamps_in_integer_domain(zbits):
    # float32(2^k - 1) rounds up to 2^k for k > 24: the clamp must happen
    # after the cast, or a top-of-scene sphere spills into the slab bits.
    zmax = (1 << zbits) - 1
    rng = np.random.RandomState(zbits)
    z = np.concatenate([rng.random(500), [0.0, 1.0, -0.25, 1.5]]).astype("float32")
    lo = np.float32(0.0)
    scale = np.float32(zmax) / np.float32(1.0)
    got = columns._quantize(torch.from_numpy(z), torch.tensor(lo), torch.tensor(scale), zmax)
    want = jcolumns._quantize(jnp.asarray(z), jnp.float32(lo), jnp.float32(scale), zmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert int(got.max()) == zmax


@pytest.mark.parametrize("n,gx", [(2, None), (4096, None), (10 ** 6, None),
                                  (10 ** 6, 300), (5000, 4096)])
def test_slab_config(n, gx):
    assert slabs.default_slab_config(n, gx=gx) == jslabs.default_slab_config(n, gx=gx)
    g = slabs.default_slab_config(n, gx=gx)[0]
    assert slabs._xbits_z(g) == jslabs._xbits_z(g)


@pytest.mark.parametrize("n,r_max,ext", [
    (10 ** 6, 0.001, 1.0),       # the uniform family's own estimate
    (10 ** 6, 0.05, 1.0),        # capped at ext / (2 r_max)
    (16384, 0.01445, 0.9),
    (5000, 0.0, 1.0),            # no cap at r_max = 0
    (5000, 0.01, 0.0),           # no extent: the n-only estimate
])
def test_slab_config_from_scene_stats(n, r_max, ext):
    assert slabs.default_slab_config(n, r_max=r_max, ext=ext) \
        == jslabs.default_slab_config(n, r_max=r_max, ext=ext)


@pytest.mark.parametrize("mc", [1, 3, 4, 134, 409, 410, 1000])
def test_mask_groups(mc):
    for rpw in (1, 2, 3, 8, 48, 128):
        assert sweep.mask_groups(mc, rpw) == jsweep.mask_groups(mc, rpw)


def test_popcount_and_select_bit():
    # torch has no popcount: the SWAR version must equal lax.population_count,
    # and rank-select must equal the JAX package's.
    rng = np.random.RandomState(5)
    words = np.concatenate([
        rng.randint(0, 2 ** 32, 2000, dtype=np.int64),
        [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    pc = np.asarray(jax.lax.population_count(jnp.asarray(words)))
    tw = torch.from_numpy(words.astype(np.int64))
    np.testing.assert_array_equal(pair_emit.popcount(tw).numpy(), pc)
    rank = (rng.randint(0, 64, words.size) % np.maximum(pc, 1)).astype(np.int32)
    got = pair_emit.select_bit(tw, torch.from_numpy(rank.astype(np.int64)))
    want = jfill._select_bit(jnp.asarray(words), jnp.asarray(rank))
    live = pc > 0
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])
