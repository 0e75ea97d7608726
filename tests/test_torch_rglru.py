"""The port's RG-LRU hybrid (``recurrentgemma-2b`` family) against the JAX package's, on the CPU.

Both packages run the smoke config ("rra": two recurrent layers and one
local-attention layer, window 32) on the same weights (``interop.lm_params``),
in float32:

* ``_lru_scan`` at S = 1, 255, 256, 512 and 600, ``_lru_gates`` (the tanh
  GELU and the gates), ``rec_block_apply`` and ``rec_block_decode`` within
  1e-5; a length the chunk rule does not divide is refused by both;
* ``forward`` logits within 1e-4 over S = 40 > the window (the local
  attention masks);
* ``decode_step`` logits within 1e-4 of JAX's ``lm_decode_step`` at every
  step of 40, the ring wrapping past the window, and the port's decode ≡
  its forward within 5e-4 at every step; the state and ring within 1e-5 of
  JAX's per-layer caches;
* a batched decode step with one position a row (the serving engine's)
  equals per-row decodes, the ring included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jr
from repro.models.registry import get_model as j_get_model
from repro_torch import interop
from repro_torch.models import rglru as r
from repro_torch.models.registry import get_model

ARCH = "recurrentgemma-2b"


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


def _scan_inputs(s, seed, dr=24):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (2, s, dr)).astype(np.float32)
    bx = rng.normal(size=(2, s, dr)).astype(np.float32)
    return a, bx, rng.normal(size=(2, dr)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 255, 256, 512, 600])
def test_lru_scan_matches_jax(s):
    a, bx, h0 = _scan_inputs(s, s)
    hs, h = r._lru_scan(_t(a), _t(bx), _t(h0))
    jhs, jh = jr._lru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    assert hs.shape == (2, s, 24)
    np.testing.assert_allclose(hs.numpy(), _np(jhs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [513, 769])
def test_lru_scan_refuses_the_lengths_jax_refuses(s):
    a, bx, h0 = _scan_inputs(s, 1)
    with pytest.raises(TypeError):                  # JAX's reshape into chunks fails
        jr._lru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        r._lru_scan(_t(a), _t(bx), _t(h0))


def test_gates_and_recurrent_block_match_jax(pair):
    japi, jp, api, tp = pair
    cfg, jcfg = api.cfg, japi.cfg
    layer, jlayer = tp["blocks"][1]["kind_r"], jp["blocks"][1]["kind_r"]
    rng = np.random.default_rng(5)
    xc = rng.normal(size=(2, 12, cfg.d_rnn)).astype(np.float32)
    for got, want in zip(r._lru_gates(layer, _t(xc)), jr._lru_gates(jlayer, jnp.asarray(xc))):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    out, (h, conv) = r.rec_block_apply(layer, _t(x), cfg)
    jout, (jh, jconv) = jr.rec_block_apply(jlayer, jnp.asarray(x), jcfg)
    for got, want in ((out, jout), (h, jh), (conv, jconv)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    step = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    out, cache = r.rec_block_decode(layer, _t(step), {"h": h.clone(), "conv": conv.clone()},
                                    cfg)
    jout, jcache = jr.rec_block_decode(jlayer, jnp.asarray(step), {"h": jh, "conv": jconv},
                                       jcfg)
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5, atol=1e-5)
    for name in ("h", "conv"):
        np.testing.assert_allclose(cache[name].numpy(), _np(jcache[name]), rtol=1e-5,
                                   atol=1e-5)


def test_forward_matches_jax_past_the_window(pair):
    japi, jp, api, tp = pair
    assert api.cfg.window == 32 and api.cfg.pattern() == "rra"
    toks = np.random.default_rng(6).integers(1, 200, (2, 40)).astype(np.int32)
    want = _np(japi.forward(jp, jnp.asarray(toks)))
    got = api.forward(tp, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 40, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    last = api.forward(tp, torch.from_numpy(toks).long(), last_only=True)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=1e-4)


def test_decode_step_matches_jax_and_forward_past_the_ring(pair):
    japi, jp, api, tp = pair
    toks = np.random.default_rng(7).integers(1, 200, (2, 40)).astype(np.int32)
    full = api.forward(tp, torch.from_numpy(toks).long())
    jcache, cache = japi.init_cache(2, 64), api.init_cache(2, 64)
    assert cache["attn"]["k"].shape == (1, 2, 32, 1, api.cfg.hd)     # min(window, max_len)
    assert cache["rec"]["h"].shape == (2, 2, api.cfg.d_rnn)
    for t in range(40):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
        tl, cache = api.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)
        assert float((full[:, t] - tl[:, 0]).abs().max()) < 5e-4, t
    seen = {"rec": 0, "attn": 0}
    for kind, jlc in zip(api.cfg.pattern(), jcache):
        group = "rec" if kind == "r" else "attn"
        for name, buf in cache[group].items():
            np.testing.assert_allclose(buf[seen[group]].numpy(), _np(jlc[name]), rtol=0,
                                       atol=1e-5)
        seen[group] += 1


def test_batched_decode_with_row_positions_equals_row_decodes(pair):
    _, _, api, tp = pair
    toks = torch.from_numpy(np.random.default_rng(8).integers(1, 200, (3, 40))).long()
    starts = [0, 17, 36]        # the last row's ring has wrapped
    cache = api.init_cache(3, 64)
    rows = []
    for b, n in enumerate(starts):
        row_cache = {g: {k: v[:, b:b + 1] for k, v in bufs.items()} for g, bufs in cache.items()}
        for t in range(n):
            api.decode_step(tp, row_cache, toks[b:b + 1, t:t + 1], t)
        single = {g: {k: v.clone() for k, v in bufs.items()} for g, bufs in row_cache.items()}
        rows.append(api.decode_step(tp, single, toks[b:b + 1, n:n + 1], n)[0])
    pos = torch.tensor(starts)
    got, _ = api.decode_step(tp, cache, toks[torch.arange(3), pos][:, None], pos)
    torch.testing.assert_close(got, torch.cat(rows), rtol=0, atol=1e-5)


def test_init_follows_the_seed_and_jax_shapes():
    api = get_model(ARCH, smoke=True, device="cpu")
    a, b, c = api.init(0), api.init(0), api.init(1)
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    assert "head" not in a                          # tied
    jshapes = jax.eval_shape(j_get_model(ARCH, smoke=True).init, jax.random.PRNGKey(0))
    assert [jax.tree.map(lambda t: tuple(t.shape), blk) for blk in a["blocks"]] == \
        [jax.tree.map(lambda s: s.shape, blk) for blk in jshapes["blocks"]]
    lam = a["blocks"][0]["kind_r"]["lam"]
    decay = torch.exp(-r.LRU_C * torch.nn.functional.softplus(lam))     # a at r = 1
    assert float(decay.min()) >= 0.9 * 0.999 and float(decay.max()) <= 0.999 * 1.001
