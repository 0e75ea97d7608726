"""The port's MLA attention (DeepSeek-V2) against the JAX package's, on the CPU.

Both run the same weights (the JAX ``mla_init`` pytree) on the same inputs,
at deepseek-v2's smoke width (4 heads, hd 16, rope dims 8, v dims 16,
kv_lora 32), with the low-rank query (``q_lora`` 48) and without
(``q_lora`` 0, the ``wq`` path), in float32:

* ``mla_apply`` (per-head k and v from the latent, then flash attention at
  q·k head dim 24 against v's 16) within 1e-5;
* ``mla_decode`` (matrix-absorbed, in latent space) step by step from
  position 0: the output within 1e-5 and the latent caches ``c`` and
  ``kr`` within 1e-6 at every step; the port takes a (B,) position (the JAX
  package a scalar), here every row at the same one;
* decode ≡ prefill: the last decode step's output against ``mla_apply``'s
  last position within 1e-4 (``tests/test_models_smoke.py``'s bound);
* rows at different positions in one step equal the rows decoded alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tf

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module", params=[48, 0], ids=["q_lora", "no_q_lora"])
def pair(request):
    jcfg = dataclasses.replace(j_smoke_config(ARCH), q_lora=request.param)
    cfg = dataclasses.replace(smoke_config(ARCH), q_lora=request.param)
    jp = jtf.mla_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = {k: interop._weight(np.asarray(v), "cpu") for k, v in jp.items()}
    assert ("wq" in tp) == (request.param == 0)
    return jcfg, jp, cfg, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def test_mla_apply_matches_jax(pair):
    jcfg, jp, cfg, tp = pair
    x = _x(cfg, 2, 24, 0)
    want = np.asarray(jtf.mla_apply(jp, jnp.asarray(x), jcfg))
    got = tf.mla_apply(tp, torch.from_numpy(x), cfg)
    assert got.shape == want.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    pos = np.stack([np.arange(24), np.arange(24) + 9]).astype(np.int32)
    np.testing.assert_allclose(
        tf.mla_apply(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos).long()).numpy(),
        np.asarray(jtf.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))),
        rtol=0, atol=1e-5)


def test_mla_decode_matches_jax_and_prefill(pair):
    jcfg, jp, cfg, tp = pair
    b, steps, s_max = 2, 12, 16
    x = _x(cfg, b, steps, 1)
    jc = jnp.zeros((b, s_max, cfg.kv_lora), jnp.float32)
    jkr = jnp.zeros((b, s_max, cfg.rope_head_dim), jnp.float32)
    tc = torch.zeros(b, s_max, cfg.kv_lora)
    tkr = torch.zeros(b, s_max, cfg.rope_head_dim)
    for t in range(steps):
        jout, jc, jkr = jtf.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jkr,
                                       jnp.asarray(t, jnp.int32), jcfg)
        tout, tc, tkr = tf.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, tkr,
                                      torch.full((b,), t, dtype=torch.int64), cfg)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), rtol=0, atol=1e-6)
    full = tf.mla_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(tout[:, 0].numpy(), full[:, -1].numpy(), rtol=0, atol=1e-4)


def test_mla_decode_rows_at_their_own_positions(pair):
    _, _, cfg, tp = pair
    b, s_max = 3, 16
    x = torch.from_numpy(_x(cfg, b, 10, 2))
    starts = [0, 4, 9]
    c = torch.zeros(b, s_max, cfg.kv_lora)
    kr = torch.zeros(b, s_max, cfg.rope_head_dim)
    rows = []
    for r, n in enumerate(starts):
        rc, rkr = c[r:r + 1], kr[r:r + 1]             # views: the prefix lands in c, kr
        for t in range(n):
            tf.mla_decode(tp, x[r:r + 1, t:t + 1], rc, rkr, torch.tensor([t]), cfg)
        out, _, _ = tf.mla_decode(tp, x[r:r + 1, n:n + 1], rc.clone(), rkr.clone(),
                                  torch.tensor([n]), cfg)
        rows.append(out)
    pos = torch.tensor(starts)
    got, c, kr = tf.mla_decode(tp, x[torch.arange(b), pos][:, None], c, kr, pos, cfg)
    torch.testing.assert_close(got, torch.cat(rows), rtol=0, atol=1e-6)
    for r, n in enumerate(starts):                      # the step wrote row r at pos[r] only
        assert bool(c[r, n].abs().sum() > 0) and bool((c[r, n + 1:] == 0).all())
