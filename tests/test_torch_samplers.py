"""The port's device samplers against ``repro.core.samplers``.

Priorities, log-weights and bounds are held equal element for element; the
group log-sum-exps ``c`` to rtol 1e-6 (float32 exp/log implementations
differ between XLA and torch).  Draws — ``tl_sample`` and the plain
``two_level_draw`` — must pick the same index as JAX for every key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.samplers import bsls_jax as jtl
from repro.core.samplers import group_argmax as jga
from repro.kernels.bsls_draw.ops import two_level_draw as jax_two_level_draw
from repro_torch import prng
from repro_torch.core.samplers import group_argmax as tga
from repro_torch.core.samplers import two_level as ttl
from repro_torch.kernels import launch_counts
from repro_torch.kernels.bsls_draw import two_level_draw


def _weights(d, seed, scale=3.0):
    return np.random.default_rng(seed).normal(0, scale, size=d).astype(np.float32)


def _touched(d, seed, k=40):
    rng = np.random.default_rng(seed + 100)
    # duplicates and dropped lanes (idx >= d); no idx 0, where JAX rewrites a
    # dropped lane's old value and a valid lane's new one in no set order
    idx = rng.integers(1, d + 5, size=k).astype(np.int32)
    return idx, np.abs(rng.normal(0, 4, size=k)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 17, 100, 600])
def test_group_shape_equal(d):
    assert ttl._group_shape(d) == jtl._group_shape(d)


@pytest.mark.parametrize("d", [17, 600])
def test_tl_init_and_update_match_jax(d):
    lw = _weights(d, 0)
    js, ts = jtl.tl_init(jnp.asarray(lw)), ttl.tl_init(torch.from_numpy(lw))
    np.testing.assert_array_equal(np.asarray(js.v), ts.v.numpy())
    np.testing.assert_allclose(np.asarray(js.c), ts.c.numpy(), rtol=1e-6)
    idx, vals = _touched(d, 1)
    # duplicates must carry one value, as in every solver call
    vals = np.abs(_weights(d + 5, 2))[idx]
    js2 = jtl.tl_update(js, jnp.asarray(idx), jnp.asarray(vals))
    ts2 = ttl.tl_update(ts, torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(np.asarray(js2.v), ts2.v.numpy())
    np.testing.assert_allclose(np.asarray(js2.c), ts2.c.numpy(), rtol=1e-6)
    assert int(ts2.touched.sum()) == 0
    np.testing.assert_array_equal(ts.v.numpy().ravel()[:d], lw)   # functional: input kept


@pytest.mark.parametrize("d", [17, 600])
def test_ga_update_and_get_next_match_jax(d):
    pr = np.abs(_weights(d, 3))
    js, ts = jga.ga_init(jnp.asarray(pr)), tga.ga_init(torch.from_numpy(pr))
    np.testing.assert_array_equal(np.asarray(js.p), ts.p.numpy())
    np.testing.assert_array_equal(np.asarray(js.bound), ts.bound.numpy())
    for rnd in range(6):
        idx, _ = _touched(d, 10 + rnd)
        vals = np.abs(_weights(d + 5, 20 + rnd, scale=2.0))[idx]
        js = jga.ga_update(js, jnp.asarray(idx), jnp.asarray(vals))
        ts = tga.ga_update(ts, torch.from_numpy(idx), torch.from_numpy(vals))
        np.testing.assert_array_equal(np.asarray(js.p), ts.p.numpy())
        np.testing.assert_array_equal(np.asarray(js.bound), ts.bound.numpy())
        j_ref, js = jga.ga_get_next(js)
        j, ts = tga.ga_get_next(ts)
        assert j == int(j_ref), rnd
        assert j == int(np.argmax(ts.p.numpy().ravel()))   # the exact argmax
        np.testing.assert_array_equal(np.asarray(js.bound), ts.bound.numpy())


def test_ga_get_next_breaks_ties_like_jax():
    pr = np.zeros(50, np.float32)
    pr[[3, 17, 41]] = 2.0                                  # an exact three-way tie
    js, ts = jga.ga_init(jnp.asarray(pr)), tga.ga_init(torch.from_numpy(pr))
    bump = np.array([41], np.int32), np.array([2.0], np.float32)
    js = jga.ga_update(js, jnp.asarray(bump[0]), jnp.asarray(bump[1]))
    ts = tga.ga_update(ts, torch.from_numpy(bump[0]), torch.from_numpy(bump[1]))
    assert tga.ga_get_next(ts)[0] == int(jga.ga_get_next(js)[0])


@pytest.mark.parametrize("d", [600, 2000])
def test_tl_sample_and_plain_draw_match_jax_for_300_keys(d):
    lw = _weights(d, 5, scale=2.0)
    js, ts = jtl.tl_init(jnp.asarray(lw)), ttl.tl_init(torch.from_numpy(lw))
    draw = jax.jit(jax_two_level_draw)
    before = launch_counts()["two_level_draw"]
    for seed in range(300):
        key = jax.random.PRNGKey(seed)
        ref = int(jtl.tl_sample(js, key))
        assert int(draw(js.c, js.v, key)) == ref, seed
        pkey = prng.PRNGKey(seed)
        assert int(ttl.tl_sample(ts, pkey)) == ref, seed
        assert int(two_level_draw(ts.c, ts.v, pkey)[0]) == ref, seed
    assert launch_counts()["two_level_draw"] == before   # CPU tensors: plain version
