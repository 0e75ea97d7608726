"""The port's objectives, accountant and config against the JAX package.

Tolerances: the torch maps against the jnp maps at rtol 1e-6 (float32,
different exp/log/sqrt implementations); numpy twins, Lipschitz constants,
flags and the accountant's formulas exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro.core.dp import accountant as ja
from repro_torch.core import losses as tl
from repro_torch.core.dp import accountant as ta
from repro_torch.core.solvers import config as tc

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]


def _inputs(seed=0, n=500):
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 3, size=n).astype(np.float32)
    m[:4] = [0.0, 1.0, -1.0, 0.5]   # the kinks of hinge and huber
    y = (rng.random(n) < 0.5).astype(np.float32)
    return m, y


@pytest.mark.parametrize("loss", LOSSES)
def test_loss_maps_match_jax(loss):
    m, y = _inputs()
    jo, to = jl.get_loss(loss), tl.get_loss(loss)
    assert to.separable == jo.separable
    assert to.lipschitz == jo.lipschitz
    assert to.smooth == jo.smooth
    tm, ty = torch.from_numpy(m), torch.from_numpy(y)
    np.testing.assert_allclose(to.grad(tm, ty).numpy(), np.asarray(jo.grad(jnp.asarray(m),
                               jnp.asarray(y))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to.h(tm, ty).numpy(), np.asarray(jo.h(jnp.asarray(m),
                               jnp.asarray(y))), rtol=1e-6, atol=1e-7)
    m64, y64 = m.astype(np.float64), y.astype(np.float64)
    np.testing.assert_array_equal(to.grad_np(m64, y64), jo.grad_np(m64, y64))
    if to.separable:
        np.testing.assert_array_equal(to.split_grad_np(m64), jo.split_grad_np(m64))


@pytest.mark.parametrize("loss", LOSSES)
def test_loss_values_match_jax(loss):
    m, y = _inputs(seed=2)
    jo, to = jl.get_loss(loss), tl.get_loss(loss)
    tm, ty = torch.from_numpy(m), torch.from_numpy(y)
    ref = np.asarray(jo.value(jnp.asarray(m), jnp.asarray(y)))
    np.testing.assert_allclose(to.value(tm, ty).numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(to.mean_value(tm, ty)),
                               float(jo.mean_value(jnp.asarray(m), jnp.asarray(y))),
                               rtol=1e-6)
    m64, y64 = m.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(to.value_np(m64, y64), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to.value_np(m64, y64),
                               to.value(torch.from_numpy(m64), torch.from_numpy(y64)).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_loss_kernel_ids_are_distinct():
    assert sorted(o.kernel_id for o in tl.OBJECTIVES.values()) == list(range(5))
    with pytest.raises(KeyError):
        tl.get_loss("hinge")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("steps", [10, 500, 4000])
def test_em_log_weight_scale_equal(loss, steps):
    kw = dict(epsilon=1.0, delta=1e-6, steps=steps, n_rows=20242,
              lipschitz=tl.get_loss(loss).lipschitz)
    assert ta.em_log_weight_scale(**kw) == ja.em_log_weight_scale(**kw)
    assert (ta.fw_noise_scale(epsilon=0.5, delta=1e-5, steps=steps, lam=50.0, lipschitz=1.0,
                              n_rows=1000)
            == ja.fw_noise_scale(epsilon=0.5, delta=1e-5, steps=steps, lam=50.0,
                                 lipschitz=1.0, n_rows=1000))


def test_privacy_accountant_equal():
    a, b = ta.PrivacyAccountant(1.0, 1e-6, 100), ja.PrivacyAccountant(1.0, 1e-6, 100)
    for k in (1, 10, 39):
        a.spend(k)
        b.spend(k)
        assert a.spent_epsilon() == b.spent_epsilon()
    assert a.to_state() == b.to_state()
    with pytest.raises(RuntimeError):
        a.spend(100)
    with pytest.raises(ValueError):
        ta.per_step_epsilon(0.0, 1e-6, 10)


@pytest.mark.parametrize("field,value,item", [("mesh", (2, 2), "A12")])
def test_unported_config_fields_refused(field, value, item):
    """Every field of the JAX package's FWConfig is ported; the last, ``mesh``,
    came with the sharded engine (ROADMAP.md item ``item``)."""
    cfg = dataclasses.replace(tc.FWConfig(device="cpu"), **{field: value})
    assert tc.check_supported(cfg) is None and tc._UNSUPPORTED == ()
    from repro.core.solvers.config import FWConfig as JC
    assert getattr(cfg, field) == getattr(dataclasses.replace(JC(), **{field: value}), field)


@pytest.mark.parametrize("field,value", [
    ("gap_tol", 1e-3), ("max_seconds", 5.0), ("chunk_steps", 8), ("selection", "gumbel"),
    ("screen_every", 2), ("lambdas", (3.0, 2.0)),
])
def test_ported_config_fields_accepted(field, value):
    cfg = dataclasses.replace(tc.FWConfig(device="cpu"), **{field: value})
    tc.check_supported(cfg)
    from repro.core.solvers.config import FWConfig as JC
    assert cfg.early_stopping == dataclasses.replace(JC(), **{field: value}).early_stopping


def test_config_defaults_follow_the_jax_package():
    from repro.core.solvers.config import FWConfig as JC
    ours, theirs = tc.FWConfig(), JC()
    for f in dataclasses.fields(theirs):
        if f.name == "interpret":
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.device == "cuda" and ours.backend == "dense"
    assert not hasattr(ours, "interpret")
    assert tc.STOP_MAX_STEPS == "max_steps"
