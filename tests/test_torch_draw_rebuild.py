"""The draw that rebuilds: ``two_level_draw`` with ``touched`` rebuilds the
groups the last step touched, then draws, in one launch on the card; its
plain version runs the plain rebuild, then the draw.

Held against the JAX package's step pair (``tl_update``, then
``repro.kernels.bsls_draw.ops.two_level_draw`` under ``jax.jit``): the same
index for every key, and ``c`` within rtol 1e-6 (float32 exp/log differ
between XLA and torch, as in ``test_torch_samplers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.samplers import bsls_jax as jtl
from repro.kernels.bsls_draw.ops import two_level_draw as jax_two_level_draw
from repro_torch import prng
from repro_torch.core.samplers import two_level as ttl
from repro_torch.kernels import launch_counts
from repro_torch.kernels.bsls_draw import two_level_draw
from repro_torch.kernels.bsls_draw.ops import rebuild_touched
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref


def _step_touches(d, step, k=25):
    """One step's touched coordinates (repeats included, each with one value)."""
    rng = np.random.default_rng(1000 + step)
    idx = rng.integers(0, d, size=k).astype(np.int32)
    vals = np.abs(rng.normal(0, 3, size=d)).astype(np.float32)[idx]
    return idx, vals


@pytest.mark.parametrize("d", [600, 2000])
def test_scatter_then_rebuilding_draw_matches_jax_for_300_keys(d):
    lw = np.random.default_rng(d).normal(0, 2, size=d).astype(np.float32)
    js, ts = jtl.tl_init(jnp.asarray(lw)), ttl.tl_init(torch.from_numpy(lw))
    update, draw = jax.jit(jtl.tl_update), jax.jit(jax_two_level_draw)
    before = launch_counts()["two_level_draw"]
    for seed in range(300):
        idx, vals = _step_touches(d, seed)
        js = update(js, jnp.asarray(idx), jnp.asarray(vals))
        ttl.tl_scatter_(ts, torch.from_numpy(idx), torch.from_numpy(vals))
        assert int(ts.touched.sum()) > 0
        got = two_level_draw_ref(ts.c, ts.v, prng.PRNGKey(seed), touched=ts.touched)
        assert int(got) == int(draw(js.c, js.v, jax.random.PRNGKey(seed))), seed
        assert int(ts.touched.sum()) == 0, seed
        np.testing.assert_array_equal(np.asarray(js.v), ts.v.numpy())
        np.testing.assert_allclose(np.asarray(js.c), ts.c.numpy(), rtol=1e-6, err_msg=seed)
    # the wrapper on CPU tensors runs the same plain version, no launch
    idx, vals = _step_touches(d, 300)
    ttl.tl_scatter_(ts, torch.from_numpy(idx), torch.from_numpy(vals))
    ref = ts.clone()
    want = two_level_draw_ref(ref.c, ref.v, prng.PRNGKey(7), touched=ref.touched)
    got = two_level_draw(ts.c, ts.v, prng.PRNGKey(7), touched=ts.touched)
    assert torch.equal(got, want) and torch.equal(ts.c, ref.c)
    assert int(ts.touched.sum()) == 0
    assert launch_counts()["two_level_draw"] == before


@pytest.mark.parametrize("d", [17, 600])
def test_rebuild_only_equals_tl_rebuild(d):
    lw = np.random.default_rng(3).normal(0, 2, size=d).astype(np.float32)
    state = ttl.tl_init(torch.from_numpy(lw))
    idx, vals = _step_touches(d, 1, k=max(2, d // 10))
    ttl.tl_scatter_(state, torch.from_numpy(idx), torch.from_numpy(vals))
    want = state.clone()
    ttl.tl_rebuild_(want)
    c_old = state.c.clone()
    rebuild_touched(state.c, state.v, state.touched)
    assert torch.equal(state.c, want.c) and int(state.touched.sum()) == 0
    groups = np.unique(idx // state.group_size)
    fresh = ttl.logsumexp_rows(state.v)
    assert torch.equal(state.c[groups], fresh[groups])
    kept = np.setdiff1d(np.arange(state.c.numel()), groups)
    assert torch.equal(state.c[kept], c_old[kept])               # untouched groups kept
    jax_state = jtl.tl_update(jtl.tl_init(jnp.asarray(lw)), jnp.asarray(idx),
                              jnp.asarray(vals))
    np.testing.assert_allclose(np.asarray(jax_state.c), state.c.numpy(), rtol=1e-6)


def test_masked_draw_rebuilds_then_returns_the_sentinel():
    d = 600
    lw = np.random.default_rng(4).normal(0, 2, size=d).astype(np.float32)
    state = ttl.tl_init(torch.from_numpy(lw))
    idx, vals = _step_touches(d, 2)
    ttl.tl_scatter_(state, torch.from_numpy(idx), torch.from_numpy(vals))
    want = state.clone()
    ttl.tl_rebuild_(want)
    got = two_level_draw(state.c, state.v, prng.PRNGKey(3), done=torch.tensor(True),
                         touched=state.touched)
    assert int(got) == -1
    assert torch.equal(state.c, want.c) and int(state.touched.sum()) == 0
    live = two_level_draw(state.c, state.v, prng.PRNGKey(3), done=torch.tensor(False),
                          touched=state.touched)
    assert int(live) == int(two_level_draw_ref(want.c, want.v, prng.PRNGKey(3)))
