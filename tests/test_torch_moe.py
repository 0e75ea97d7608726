"""The port's MoE layer (``moe_apply``) against the JAX package's, on the CPU.

Both run the same expert weights (the JAX ``moe_init`` pytree carried over
as the LM's weights are) on the same tokens, at deepseek-v2's and
kimi-k2's smoke widths (4 experts, top-2, a shared expert):

* full capacity (T = 32, the forward's) and capacity 9 (which drops about
  half the lanes, as ``tests/test_models_smoke.py`` drops them), float32
  and bfloat16: ``y`` within 1e-5 in float32; ``dropped`` equal,
  ``moe_aux`` within 1e-6 relative (a float32 mean and sum, each
  package's order);
* bfloat16, isolated: with the SiLU rounded as XLA rounds it on the CPU
  (bf16 after each of its neg, exp, add and divide, then the product),
  ``y`` equals JAX's bit for bit, so the routing, the dispatch buffer, the
  expert products, the gates, the combine and the shared expert agree
  exactly.  With ``F.silu`` (float32 inside, one rounding) the SiLU alone
  differs by up to 1.5 bf16 spacings and ``y`` by 2.76 spacings of
  max(|y|, the row's RMS); the bound is 4, the one flash's bf16 route has;
* the combine's order: each token's k terms added in ``x.dtype`` in
  increasing expert id, bit for bit against a serial loop;
* full capacity drops nothing, and the JAX package's ``moe_combine`` and
  ``moe_local_groups`` knobs, kept in the configs, do not change the bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as j_smoke_config
from repro.models import common as jcm
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.models import common as cm

BF16_SPACING = 2.0 ** -7


def _carry(tree):
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    return interop._weight(np.asarray(tree), "cpu")


def _pair(arch, dtype, **overrides):
    jcfg = dataclasses.replace(j_smoke_config(arch), dtype=dtype, **overrides)
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype, **overrides)
    jp = jcm.moe_init(jax.random.PRNGKey(0), jcfg, jcfg.jdtype)
    return jcfg, jp, cfg, _carry(jp)


def _tokens(cfg, t=32, seed=1):
    x = np.random.default_rng(seed).normal(size=(t, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32)
    return jx, _carry(jx)


def _xla_silu(h):
    """SiLU rounded as XLA computes it in bfloat16 on the CPU: 1 / (1 +
    exp(-h)) with a bf16 rounding after each op, then h times that."""
    r = lambda v: v.to(torch.bfloat16).float()
    s = r(1 / r(r(torch.exp(-h.float())) + 1))
    return (h.float() * s).to(h.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [32, 9])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_apply_matches_jax(arch, capacity, dtype):
    jcfg, jp, cfg, tp = _pair(arch, dtype)
    jx, tx = _tokens(cfg)
    jy, jaux = jcm.moe_apply(jp, jx, jcfg, capacity=capacity)
    ty, taux = cm.moe_apply(tp, tx, cfg, capacity=capacity)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    want, got = np.asarray(jy.astype(jnp.float32)), ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
        assert (np.abs(got - want) <= 4 * BF16_SPACING * np.maximum(np.abs(want), rms)).all()
    assert float(taux["dropped"]) == float(jaux["dropped"])
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]), rtol=1e-6)
    if capacity == 9:
        assert float(taux["dropped"]) > 0.3            # the capacity binds


@pytest.mark.parametrize("capacity", [32, 9])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_bf16_moe_equals_jax_bit_for_bit_but_for_the_silu(arch, capacity, monkeypatch):
    jcfg, jp, cfg, tp = _pair(arch, "bfloat16")
    jx, tx = _tokens(cfg)
    jy, _ = jcm.moe_apply(jp, jx, jcfg, capacity=capacity)
    monkeypatch.setattr(cm.F, "silu", _xla_silu)
    ty, _ = cm.moe_apply(tp, tx, cfg, capacity=capacity)
    assert torch.equal(ty, _carry(jy))
    # and the SiLU is the whole difference: F.silu rounds once
    h = tx @ tp["w1"][0]
    monkeypatch.undo()
    one = F.silu(h).float()
    assert not torch.equal(one, _xla_silu(h).float())
    assert ((one - _xla_silu(h).float()).abs() <= 1.5 * BF16_SPACING * one.abs()).all()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_full_capacity_drops_nothing(arch):
    _, _, cfg, tp = _pair(arch, "float32")
    _, tx = _tokens(cfg)
    y, aux = cm.moe_apply(tp, tx, cfg, capacity=32)
    assert float(aux["dropped"]) == 0.0
    y_more, _ = cm.moe_apply(tp, tx, cfg, capacity=64)           # capacity past T: the same
    assert torch.equal(y_more, y)


@pytest.mark.parametrize("knob", [{"moe_combine": "scatter"}, {"moe_local_groups": 4}],
                         ids=["combine", "local_groups"])
def test_jax_dispatch_knobs_do_not_change_the_bits(knob):
    _, _, cfg, tp = _pair("kimi-k2-1t-a32b", "bfloat16")
    _, tx = _tokens(cfg, seed=4)
    y, _ = cm.moe_apply(tp, tx, cfg, capacity=32)
    y_knob, _ = cm.moe_apply(tp, tx, dataclasses.replace(cfg, **knob), capacity=32)
    assert torch.equal(y_knob, y)


def _serial_combine(contrib, sort_idx, t, k):
    """The combine spelled out: for each token, a zero row of the dtype, then
    its lanes' rows added one at a time in the sorted order."""
    y = torch.zeros(t, contrib.shape[1], dtype=contrib.dtype)
    for pos, lane in enumerate(sort_idx.tolist()):
        tok = lane // k
        y[tok] = y[tok] + contrib[pos]
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_adds_in_expert_order_bit_for_bit(dtype):
    t, k, e, d = 64, 6, 16, 48
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)])   # distinct
    sort_idx = torch.argsort(idx.reshape(-1), stable=True)
    # magnitudes spread over 2^±12, so the order of the adds shows in the bits
    scale = 2.0 ** torch.randint(-12, 13, (t * k, 1), generator=g).float()
    contrib = (torch.randn(t * k, d, generator=g) * scale).to(dtype)
    got = cm.combine_in_order(contrib, sort_idx, t, k)
    want = _serial_combine(contrib, sort_idx, t, k)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    # the sorted order is the experts' ascending order, token by token
    order = torch.empty_like(sort_idx)
    order[sort_idx] = torch.arange(t * k)
    lanes = order.reshape(t, k).sort(1).values
    assert (idx.reshape(-1)[sort_idx][lanes].diff(dim=1) > 0).all()
    # and another order gives other bits: the test can see the order
    reversed_sum = torch.zeros(t, d, dtype=dtype)
    for j in reversed(range(k)):
        reversed_sum = reversed_sum + contrib[lanes[:, j]]
    assert not torch.equal(reversed_sum, want)


def test_moe_init_matches_jax_shapes_and_dtypes():
    _, jp, cfg, _ = _pair("deepseek-v2-236b", "bfloat16")
    p = cm.moe_init(torch.Generator().manual_seed(0), cfg, cfg.torch_dtype)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), p,
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert got == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert p["router"].dtype == torch.float32                       # even in bf16
    assert p["shared"]["w1"].shape == (cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts)
    r = p["router"]
    assert float(r.abs().max()) <= 2 * 0.02 + 1e-7 and abs(float(r.std()) / 0.02 - 0.88) < 0.1
