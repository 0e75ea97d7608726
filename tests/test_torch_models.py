"""The port's decoder LM against the JAX package's, on the CPU, at smoke size.

Both packages run the same weights (the JAX ``lm_init`` pytree carried over
by ``interop.lm_params``) and the same tokens, in float32:

* the configs of all ten archs are field-for-field copies (``param_count``
  included); an unknown arch and training (``lm_loss``, A13d) are refused
  for every family;
* ``rmsnorm``, ``rope``, ``ffn_apply``, ``attn_apply`` (or ``mla_apply``)
  and ``moe_apply`` within 1e-5;
* ``forward`` logits (and ``last_only``) within 1e-4, ``decode_step``
  logits within 1e-4 and its caches within 1e-5, for every ported arch:
  ``tinyllama-1.1b``, ``llama3.2-1b`` and ``minicpm-2b`` (tied embeddings),
  ``nemotron-4-15b`` (squared ReLU), ``chameleon-34b`` (qk-norm),
  ``deepseek-v2-236b`` (MLA, MoE, a leading dense layer) and
  ``kimi-k2-1t-a32b`` (GQA with MoE, a leading dense layer); and
  ``forward`` with the config branches no arch takes (embedding scale,
  logit softcap, GeGLU, a local window);
* the port's own decode ≡ forward within 5e-4 (``tests/test_models_smoke.py``'s
  bound), and one batched decode with a position per row equals per-row
  decodes (the serving engine's step);
* a dense config with a window decodes through a ring of the window's rows:
  JAX's decode while the position is inside the window, the windowed
  forward past it (where JAX's clamped write diverges);
* ``lm_batches`` gives the JAX package's tokens; ``init`` is seeded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.models.registry import get_model as j_get_model
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.registry import get_model

ARCHS = ["tinyllama-1.1b", "llama3.2-1b", "minicpm-2b", "nemotron-4-15b", "chameleon-34b",
         "deepseek-v2-236b", "kimi-k2-1t-a32b"]
FAMILIES = {"dense": "tinyllama-1.1b", "moe": "deepseek-v2-236b", "ssm": "falcon-mamba-7b",
            "hybrid": "recurrentgemma-2b", "encdec": "seamless-m4t-medium"}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX api, JAX params, port api, port params) on the same weights."""
    japi = j_get_model(request.param, smoke=True)
    jp = japi.init(jax.random.PRNGKey(0))
    api = get_model(request.param, smoke=True, device="cpu")
    return japi, jp, api, interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")


def _tokens(seed, b=2, s=20):
    return np.random.default_rng(seed).integers(1, 200, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies(arch):
    for ours, theirs in ((get_config(arch), j_get_config(arch)),
                         (smoke_config(arch), j_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert (ours.padded_vocab, ours.hd, ours.pattern(), ours.dt_rank_,
                ours.is_subquadratic) == (theirs.padded_vocab, theirs.hd, theirs.pattern(),
                                          theirs.dt_rank_, theirs.is_subquadratic)


def test_unported_archs_are_refused():
    """Only an unknown arch is refused; every family refuses training (A13d)."""
    assert sorted(get_config(arch).family for arch in ARCH_IDS) == sorted(
        ["encdec", "ssm", "dense", "dense", "dense", "dense", "dense", "moe", "moe", "hybrid"])
    with pytest.raises(KeyError):
        get_config("gpt-2")
    with pytest.raises(KeyError):
        get_model("gpt-2", smoke=True, device="cpu")
    for family, arch in FAMILIES.items():
        api = get_model(arch, smoke=True, device="cpu")
        assert api.cfg.family == family
        with pytest.raises(NotImplementedError, match="ROADMAP.md A13d"):
            api.loss(api.init(0), {"tokens": torch.zeros(1, 4, dtype=torch.int64)})


def test_norm_rope_ffn_attn_match_jax(pair):
    japi, jp, api, tp = pair
    cfg, jcfg = api.cfg, japi.cfg
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    scale = rng.normal(size=cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(cm.rmsnorm(_t(x), _t(scale), cfg.norm_eps).numpy(),
                               _np(jcm.rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                                               jcfg.norm_eps)), rtol=1e-5, atol=1e-5)
    heads = rng.normal(size=(2, 12, cfg.n_heads, cfg.hd)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(12) + 40]).astype(np.int32)
    np.testing.assert_allclose(
        cm.rope(_t(heads), torch.from_numpy(pos).long(), cfg.rope_theta).numpy(),
        _np(jcm.rope(jnp.asarray(heads), jnp.asarray(pos), jcfg.rope_theta)),
        rtol=1e-5, atol=1e-5)
    # the first dense-FFN layer (an MoE config's leading one) and its attention
    group = "lead_blocks" if "lead_blocks" in tp else "blocks"
    layer = jax.tree.map(lambda a: a[0], jp[group])
    np.testing.assert_allclose(cm.ffn_apply(tp[group][0]["ffn"], _t(x), cfg).numpy(),
                               _np(jcm.ffn_apply(layer["ffn"], jnp.asarray(x), jcfg)),
                               rtol=1e-5, atol=1e-5)
    attn, jattn = ((tf.mla_apply, jtf.mla_apply) if cfg.use_mla
                   else (cm.attn_apply, jcm.attn_apply))
    np.testing.assert_allclose(attn(tp[group][0]["attn"], _t(x), cfg).numpy(),
                               _np(jattn(layer["attn"], jnp.asarray(x), jcfg)),
                               rtol=1e-5, atol=1e-5)
    if cfg.n_experts:          # an MoE layer at full capacity (the forward's)
        moe = jax.tree.map(lambda a: a[0], jp["blocks"])["moe"]
        flat = x.reshape(-1, cfg.d_model)
        np.testing.assert_allclose(
            cm.moe_apply(tp["blocks"][0]["moe"], _t(flat), cfg, capacity=24)[0].numpy(),
            _np(jcm.moe_apply(moe, jnp.asarray(flat), jcfg, capacity=24)[0]),
            rtol=1e-5, atol=1e-5)


def test_forward_matches_jax(pair):
    japi, jp, api, tp = pair
    toks = _tokens(2)
    want = _np(japi.forward(jp, jnp.asarray(toks)))
    got = api.forward(tp, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 20, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    last = api.forward(tp, torch.from_numpy(toks).long(), last_only=True)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides", [
    {"qk_norm": True, "emb_scale": True, "logit_softcap": 30.0},
    {"act": "geglu", "window": 8},
    {"act": "relu2", "tie_embeddings": True},
])
def test_config_variants_match_jax(overrides):
    """Config branches on tinyllama-1.1b's widths, some of which no ported arch takes."""
    japi = j_get_model("tinyllama-1.1b", smoke=True, overrides=overrides)
    jp = japi.init(jax.random.PRNGKey(1))
    api = get_model("tinyllama-1.1b", smoke=True, device="cpu", overrides=overrides)
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")
    toks = _tokens(6)
    np.testing.assert_allclose(api.forward(tp, torch.from_numpy(toks).long()).numpy(),
                               _np(japi.forward(jp, jnp.asarray(toks))), rtol=0, atol=1e-4)


def test_decode_step_matches_jax_and_forward(pair):
    japi, jp, api, tp = pair
    toks = _tokens(3, s=10)
    jcache, cache = japi.init_cache(2, 16), api.init_cache(2, 16)
    for t in range(10):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
        tl, cache = api.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)
    assert set(cache) == set(jcache) and all(set(cache[g]) == set(jcache[g]) for g in cache)
    for group, bufs in cache.items():
        for name, buf in bufs.items():
            np.testing.assert_allclose(buf.numpy(), _np(jcache[group][name]), rtol=0, atol=1e-5)
    full = api.forward(tp, torch.from_numpy(toks).long())
    assert float((full[:, -1] - tl[:, 0]).abs().max()) < 5e-4


@pytest.fixture(scope="module")
def windowed():
    """tinyllama-1.1b's smoke widths with an 8-position window, both packages."""
    japi = j_get_model("tinyllama-1.1b", smoke=True, overrides={"window": 8})
    jp = japi.init(jax.random.PRNGKey(2))
    api = get_model("tinyllama-1.1b", smoke=True, device="cpu", overrides={"window": 8})
    return japi, jp, api, interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")


def test_windowed_ring_equals_jax_inside_the_window_and_the_forward_past_it(windowed):
    japi, jp, api, tp = windowed
    toks = _tokens(9, s=14)
    full = api.forward(tp, torch.from_numpy(toks).long())
    jfull = _np(japi.forward(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(full.numpy(), jfull, rtol=0, atol=1e-4)
    jcache, cache = japi.init_cache(2, 32), api.init_cache(2, 32)
    assert cache["main"]["k"].shape[2] == 8                          # min(window, max_len)
    for t in range(14):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
        tl, cache = api.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        assert float((full[:, t] - tl[:, 0]).abs().max()) < 5e-4, t
        if t < 8:       # past the window JAX's clamped write leaves its forward (ROADMAP.md C)
            np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=1e-4)


def test_batched_decode_with_row_positions_equals_row_decodes(pair):
    _, _, api, tp = pair
    toks = torch.from_numpy(_tokens(4, b=3, s=12)).long()
    starts = [0, 3, 7]          # row b has seen toks[b, :starts[b]] before the batched step
    cache = api.init_cache(3, 16)
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


def test_lm_batches_and_init_follow_the_seed():
    ours, theirs = lm_batches(256, 3, 9, seed=5), j_lm_batches(256, 3, 9, seed=5)
    for _ in range(2):
        np.testing.assert_array_equal(next(ours)["tokens"], next(theirs)["tokens"])
    api = get_model("llama3.2-1b", smoke=True, device="cpu")
    a, b, c = api.init(0), api.init(0), api.init(1)
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    assert "head" not in a and len(a["blocks"]) == api.cfg.n_layers
    jshapes = jax.tree.map(lambda s: s.shape[1:],
                           jax.eval_shape(j_get_model("llama3.2-1b", smoke=True).init,
                                          jax.random.PRNGKey(0))["blocks"])
    assert jax.tree.map(lambda t: tuple(t.shape), a["blocks"][0]) == jshapes
    wq = a["blocks"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / api.cfg.d_model ** 0.5     # truncated at 2σ
    assert abs(float(wq.std()) * api.cfg.d_model ** 0.5 - 0.88) < 0.05


def test_lm_params_carries_bfloat16_bits():
    cfg = dataclasses.replace(j_smoke_config("tinyllama-1.1b"), dtype="bfloat16")
    from repro.models.transformer import lm_init
    jp = lm_init(jax.random.PRNGKey(0), cfg)
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["blocks"][1]["ffn"]["w2"].float().numpy(),
                                  np.asarray(jp["blocks"]["ffn"]["w2"][1], np.float32))
    with pytest.raises(ValueError, match="layers"):
        interop.lm_params(jax.tree.map(np.asarray, jp), get_config("tinyllama-1.1b"), "cpu")
