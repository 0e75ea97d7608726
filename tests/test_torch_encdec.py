"""The port's encoder-decoder (``seamless-m4t-medium`` family) against the JAX package's, on the CPU.

Both packages run the smoke config (2 encoder and 2 decoder layers) on the
same weights (``interop.lm_params``), in float32, with S_enc ≠ S_dec so that
cross-attention runs with q and k of different lengths:

* an encoder block (bidirectional) and a decoder block (causal
  self-attention, then cross-attention over the memory) within 1e-5;
* ``forward`` on a ``{"frames", "tokens"}`` batch and on bare tokens (zero
  frames) within 1e-4;
* ``prefill_cross`` + ``decode_step`` logits within 1e-4 of JAX's at every
  step, and ≡ the port's teacher-forced forward within 5e-4 (JAX's own
  bound, ``tests/test_serve.py``);
* a batched decode step with one position a row equals per-row decodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as je
from repro.models.registry import get_model as j_get_model
from repro_torch import interop
from repro_torch.models import encdec as e
from repro_torch.models.registry import get_model

ARCH = "seamless-m4t-medium"
S_ENC, S_DEC = 24, 16


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


def _batch(seed, d, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, S_ENC, d)).astype(np.float32),
            rng.integers(1, 200, (b, S_DEC)).astype(np.int32))


def test_encoder_and_decoder_blocks_match_jax(pair):
    japi, jp, api, tp = pair
    cfg, jcfg = api.cfg, japi.cfg
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S_ENC, cfg.d_model)).astype(np.float32)
    jenc = jax.tree.map(lambda a: a[1], jp["enc_blocks"])
    np.testing.assert_allclose(e.enc_block_apply(tp["enc_blocks"][1], _t(x), cfg).numpy(),
                               _np(je.enc_block_apply(jenc, jnp.asarray(x), jcfg)),
                               rtol=1e-5, atol=1e-5)
    y = rng.normal(size=(2, S_DEC, cfg.d_model)).astype(np.float32)
    jdec = jax.tree.map(lambda a: a[0], jp["dec_blocks"])
    np.testing.assert_allclose(
        e.dec_block_apply(tp["dec_blocks"][0], _t(y), _t(x), cfg).numpy(),
        _np(je.dec_block_apply(jdec, jnp.asarray(y), jnp.asarray(x), jcfg)),
        rtol=1e-5, atol=1e-5)


def test_forward_matches_jax(pair):
    japi, jp, api, tp = pair
    frames, toks = _batch(2, api.cfg.d_model)
    want = _np(japi.forward(jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}))
    got = api.forward(tp, {"frames": _t(frames), "tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape == (2, S_DEC, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    last = api.forward(tp, {"frames": _t(frames), "tokens": torch.from_numpy(toks).long()},
                       last_only=True)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=1e-4)
    bare = api.forward(tp, torch.from_numpy(toks).long())          # zero frames, S_dec of them
    np.testing.assert_allclose(bare.numpy(), _np(japi.forward(jp, jnp.asarray(toks))),
                               rtol=0, atol=1e-4)


def test_decode_matches_jax_and_the_teacher_forced_forward(pair):
    japi, jp, api, tp = pair
    frames, toks = _batch(3, api.cfg.d_model)
    full = api.forward(tp, {"frames": _t(frames), "tokens": torch.from_numpy(toks).long()})
    jcache = je.prefill_cross(jp, japi.init_cache(2, 32), jnp.asarray(frames), japi.cfg)
    cache = e.prefill_cross(tp, api.init_cache(2, 32), _t(frames), api.cfg)
    assert cache["cross"]["len"].tolist() == [[S_ENC, S_ENC]] * api.cfg.dec_layers
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["cross"][name].numpy(), _np(jcache[f"cross_{name}"]),
                                   rtol=0, atol=1e-5)
    for t in range(S_DEC):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
        tl, cache = api.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)
        assert float((full[:, t] - tl[:, 0]).abs().max()) < 5e-4, t
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["self"][name].numpy(), _np(jcache[f"self_{name}"]),
                                   rtol=0, atol=1e-5)


def test_batched_decode_with_row_positions_equals_row_decodes(pair):
    _, _, api, tp = pair
    frames, toks = _batch(4, api.cfg.d_model, b=3)
    toks = torch.from_numpy(toks).long()
    starts = [0, 5, 11]
    cache = e.prefill_cross(tp, api.init_cache(3, 32), _t(frames), api.cfg)
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
    assert torch.equal(a["head"], b["head"]) and not torch.equal(a["head"], c["head"])
    jshapes = jax.eval_shape(j_get_model(ARCH, smoke=True).init, jax.random.PRNGKey(0))
    for group in ("enc_blocks", "dec_blocks"):
        assert len(a[group]) == 2
        assert jax.tree.map(lambda t: tuple(t.shape), a[group][0]) == \
            jax.tree.map(lambda s: s.shape[1:], jshapes[group])
