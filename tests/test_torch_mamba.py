"""The port's mamba (``falcon-mamba-7b`` family) against the JAX package's, on the CPU.

Both packages run the smoke config on the same weights (the JAX ``lm_init``
pytree carried over by ``interop.lm_params``), in float32:

* ``_causal_conv`` (with and without a carried state), ``_ssm_inputs``, the
  chunked scan ``_ssm_chunked`` at S = 1, 255, 256, 512 and 600 (one chunk,
  a ragged single chunk, two and three chunks), and ``block_apply`` /
  ``block_decode`` within 1e-5; a length the chunk rule does not divide is
  refused by both;
* ``forward`` logits within 1e-4, ``decode_step`` logits within 1e-4 of
  JAX's ``lm_decode_step`` at every step and its state within 1e-5, and the
  port's decode ≡ its forward within 5e-4 (``tests/test_models_smoke.py``'s
  bound) over S = 40;
* the port's scan keeps the JAX package's values while it forms dA and dBx
  a chunk at a time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro.models.registry import get_model as j_get_model
from repro_torch import interop
from repro_torch.models import mamba as m
from repro_torch.models.registry import get_model

ARCH = "falcon-mamba-7b"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def pair():
    japi = j_get_model(ARCH, smoke=True)
    jp = japi.init(jax.random.PRNGKey(0))
    api = get_model(ARCH, smoke=True, device="cpu")
    return japi, jp, api, interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["blocks"])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 9, 16), (4, 16), (16,)))
    state = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state else None
    got = m._causal_conv(_t(x), _t(w), _t(b), None if state is None else _t(state))
    want = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           None if state is None else jnp.asarray(state))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w_), rtol=1e-5, atol=1e-5)


def _scan_inputs(s, seed, di=16, n=8):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 0.1, (2, s, di)).astype(np.float32)
    x, b_mat, c = (rng.normal(size=shape).astype(np.float32)
                   for shape in ((2, s, di), (2, s, n), (2, s, n)))
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (di, n)).copy()
    h0 = rng.normal(size=(2, di, n)).astype(np.float32)
    return dt, x, a, b_mat, c, h0


def _jax_scan_terms(dt, x, a, b_mat):
    dt, x, a, b_mat = map(jnp.asarray, (dt, x, a, b_mat))
    return jnp.exp(dt[..., None] * a[None, None]), (dt * x)[..., None] * b_mat[:, :, None, :]


@pytest.mark.parametrize("s", [1, 255, 256, 512, 600])
def test_ssm_chunked_matches_jax(s):
    dt, x, a, b_mat, c, h0 = _scan_inputs(s, s)
    y, h = m._ssm_chunked(*map(_t, (dt, x, a, b_mat, c, h0)))
    d_a, d_bx = _jax_scan_terms(dt, x, a, b_mat)
    jy, jh = jm._ssm_chunked(d_a, d_bx, jnp.asarray(c), jnp.asarray(h0))
    assert y.shape == (2, s, 16) and h.shape == (2, 16, 8)
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [513, 769])
def test_scan_refuses_the_lengths_jax_refuses(s):
    dt, x, a, b_mat, c, h0 = _scan_inputs(s, 1)
    d_a, d_bx = _jax_scan_terms(dt, x, a, b_mat)
    with pytest.raises(AssertionError):
        jm._ssm_chunked(d_a, d_bx, jnp.asarray(c), jnp.asarray(h0))
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        m._ssm_chunked(*map(_t, (dt, x, a, b_mat, c, h0)))


def test_ssm_inputs_and_blocks_match_jax(pair):
    japi, jp, api, tp = pair
    cfg, jcfg = api.cfg, japi.cfg
    layer, jlayer = tp["blocks"][1], _layer(jp, 1)
    rng = np.random.default_rng(2)
    xc = rng.normal(size=(2, 12, cfg.d_inner)).astype(np.float32)
    dt, a, b_mat, c = m._ssm_inputs(layer, _t(xc), cfg)
    jd_a, jd_bx, jc = jm._ssm_inputs(jlayer, jnp.asarray(xc), jcfg)
    d_a = torch.exp(dt[..., None] * a)
    d_bx = (dt * _t(xc))[..., None] * b_mat[:, :, None, :]
    for got, want in ((d_a, jd_a), (d_bx, jd_bx), (c, jc)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)

    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    out, (h, conv) = m.block_apply(layer, _t(x), cfg)
    jout, (jh, jconv) = jm.block_apply(jlayer, jnp.asarray(x), jcfg)
    for got, want in ((out, jout), (h, jh), (conv, jconv)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    step = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    cache = {"h": h.clone(), "conv": conv.clone()}
    out, cache = m.block_decode(layer, _t(step), cache, cfg)
    jout, jcache = jm.block_decode(jlayer, jnp.asarray(step), {"h": jh, "conv": jconv}, jcfg)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5, atol=1e-5)
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]), rtol=1e-5,
                                   atol=1e-5)


def test_forward_matches_jax(pair):
    japi, jp, api, tp = pair
    toks = np.random.default_rng(3).integers(1, 200, (2, 40)).astype(np.int32)
    want = _np(japi.forward(jp, jnp.asarray(toks)))
    got = api.forward(tp, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 40, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    last = api.forward(tp, torch.from_numpy(toks).long(), last_only=True)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=1e-4)


def test_decode_step_matches_jax_and_forward(pair):
    japi, jp, api, tp = pair
    toks = np.random.default_rng(4).integers(1, 200, (2, 40)).astype(np.int32)
    full = api.forward(tp, torch.from_numpy(toks).long())
    jcache, cache = japi.init_cache(2, 64), api.init_cache(2, 64)
    assert set(cache) == {"main"} and set(cache["main"]) == set(jcache)
    for t in range(40):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
        tl, cache = api.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)
        assert float((full[:, t] - tl[:, 0]).abs().max()) < 5e-4
    for name, buf in cache["main"].items():
        assert buf.shape == jcache[name].shape
        np.testing.assert_allclose(buf.numpy(), _np(jcache[name]), rtol=0, atol=1e-5)


def test_init_follows_the_seed_and_jax_shapes():
    api = get_model(ARCH, smoke=True, device="cpu")
    a, b, c = api.init(0), api.init(0), api.init(1)
    assert torch.equal(a["blocks"][1]["in_proj"], b["blocks"][1]["in_proj"])
    assert not torch.equal(a["blocks"][1]["in_proj"], c["blocks"][1]["in_proj"])
    jshapes = jax.tree.map(lambda s: s.shape[1:],
                           jax.eval_shape(j_get_model(ARCH, smoke=True).init,
                                          jax.random.PRNGKey(0))["blocks"])
    assert jax.tree.map(lambda t: tuple(t.shape), a["blocks"][0]) == jshapes
    dt = torch.nn.functional.softplus(a["blocks"][0]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
