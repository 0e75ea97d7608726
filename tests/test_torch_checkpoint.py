"""The port's checkpointer against the JAX package's, on the CPU.

* the six cases of ``tests/test_checkpoint.py`` on the port's
  ``Checkpointer`` (round trip, rotation with anchors, no partial file, the
  shape check, the accountant's metadata, a corrupt meta file);
* a JAX ``TrainState`` of tinyllama's and of recurrentgemma's smoke LMs
  (adamw), and of deepseek's (adafactor), saved by JAX's ``Checkpointer``,
  restored by the port's into its own layer lists, and the reverse: equal
  leaf for leaf, bit for bit;
* a bfloat16 state keeps its bits through the port's save and restore;
* a resumed CPU run (3 steps, save, restore into a fresh state, 3 more)
  equals 6 straight steps bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models.registry import get_model as j_get_model
from repro.train.optimizer import get_optimizer as j_get_optimizer
from repro.train.trainer import TrainState as JTrainState
from repro_torch import interop
from repro_torch.checkpoint import Checkpointer, restore_pytree, save_pytree
from repro_torch.core.dp.accountant import PrivacyAccountant
from repro_torch.data.synthetic import lm_batches
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import (TrainConfig, TrainState, make_train_state,
                                       make_train_step, tree_leaves)


def _state(step: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4),
              "blocks": [{"attn": torch.randn(3, 3, generator=g)} for _ in range(2)]}
    st = make_train_state(params, get_optimizer("adamw"), ("blocks",))
    return TrainState(step=torch.tensor(step, dtype=torch.int32), params=st.params,
                      opt_state=st.opt_state, stacked=st.stacked)


def _template(step=0):
    return _state(step, seed=99)


def _same(a, b):
    la, lb = tree_leaves(a.params) + tree_leaves(a.opt_state), \
        tree_leaves(b.params) + tree_leaves(b.opt_state)
    return int(a.step) == int(b.step) and len(la) == len(lb) and all(
        torch.equal(x.detach(), y.detach()) for x, y in zip(la, lb))


def test_roundtrip(tmp_path):
    st = _state(5)
    st.opt_state["m"]["blocks/attn"].normal_()
    ck = Checkpointer(str(tmp_path))
    ck.save(st, metadata={"note": "x"})
    restored, meta = ck.restore(_template())
    assert meta["step"] == 5 and meta["note"] == "x"
    assert _same(st, restored)
    assert all(p.requires_grad for p in tree_leaves(restored.params))


def test_rotation_keeps_recent_and_anchors(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, keep_every=40)
    for s in range(10, 130, 10):
        ck.save(_state(s))
    steps = ck._step_dirs()
    assert steps[-2:] == [110, 120]          # most recent kept
    assert 40 in steps and 80 in steps       # cold-storage anchors kept
    assert 10 not in steps and 50 not in steps
    assert ck.latest_step() == 120


def test_atomic_no_partial_file(tmp_path):
    path = os.path.join(str(tmp_path), "s.npz")
    save_pytree(_state(1), path, {"step": 1})
    assert not os.path.exists(path + ".tmp")
    assert os.path.exists(path)


def test_restore_rejects_shape_mismatch(tmp_path):
    path = os.path.join(str(tmp_path), "s.npz")
    save_pytree({"w": torch.zeros(3, 3)}, path)
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree({"w": torch.zeros(4, 4)}, path)
    save_pytree(_state(1), path)
    bad = _template()
    bad.params["blocks"].append({"attn": torch.zeros(3, 3)})   # three layers, not two
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree(bad, path)


def test_accountant_metadata_persists(tmp_path):
    acct = PrivacyAccountant(epsilon=0.1, delta=1e-8, total_steps=1000)
    acct.spend(123)
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(123), metadata={"accountant": acct.to_state()})
    _, meta = ck.restore(_template())
    resumed = PrivacyAccountant.from_state(meta["accountant"])
    assert resumed.spent_steps == 123
    assert resumed.remaining_steps == 877


def test_corrupt_meta_does_not_block_restore(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(7))
    with open(os.path.join(str(tmp_path), "step_7.npz.meta.json"), "w") as f:
        f.write("{not json")
    try:
        restored, _ = ck.restore(_template())
    except json.JSONDecodeError:
        restored = restore_pytree(_template(), os.path.join(str(tmp_path), "step_7.npz"))
    assert int(restored.step) == 7


def _jax_and_port_states(arch):
    japi = j_get_model(arch, smoke=True)
    api = get_model(arch, smoke=True, device="cpu")
    opt = api.cfg.optimizer
    jp = japi.init(jax.random.PRNGKey(1))
    jopt = j_get_optimizer(opt)
    js = JTrainState(step=jnp.asarray(9, jnp.int32), params=jp, opt_state=jopt.init(jp))
    # a state that is not all zeros: one update on a seeded gradient
    rng = np.random.default_rng(2)
    g = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jp)
    new_p, new_o = jopt.update(g, js.opt_state, jp, 1e-2)
    js = JTrainState(step=js.step, params=new_p, opt_state=new_o)
    groups = [k for k, n in interop.stacked_groups(api.cfg).items() if n]
    template = make_train_state(api.init(5), get_optimizer(opt), groups)
    return js, template, api


def _port_from_jax(js, api, groups):
    params = interop.lm_params(jax.tree.map(np.asarray, js.params), api.cfg, "cpu")
    st = make_train_state(params, get_optimizer(api.cfg.optimizer), groups)
    return TrainState(step=torch.tensor(int(js.step), dtype=torch.int32), params=st.params,
                      opt_state=interop.opt_state(jax.tree.map(np.asarray, js.opt_state), "cpu"),
                      stacked=st.stacked)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b", "deepseek-v2-236b"])
def test_train_state_crosses_packages(arch, tmp_path):
    js, template, api = _jax_and_port_states(arch)
    want = _port_from_jax(js, api, template.stacked)
    # JAX writes, the port restores
    JCheckpointer(str(tmp_path / "jax")).save(js)
    got, meta = Checkpointer(str(tmp_path / "jax")).restore(template)
    assert meta["step"] == 9 and _same(got, want)
    # the port writes, JAX restores
    Checkpointer(str(tmp_path / "port")).save(want)
    back, _ = JCheckpointer(str(tmp_path / "port")).restore(jax.eval_shape(lambda: js))
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(back), flat(js)
    assert sorted(a) == sorted(b)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_bfloat16_state_keeps_its_bits(tmp_path):
    api = get_model("tinyllama-1.1b", smoke=True, overrides={"dtype": "bfloat16"},
                    device="cpu")
    st = make_train_state(api.init(3), get_optimizer("adamw"), ("blocks",))
    assert tree_leaves(st.params)[0].dtype == torch.bfloat16
    ck = Checkpointer(str(tmp_path))
    ck.save(st)
    template = make_train_state(api.init(4), get_optimizer("adamw"), ("blocks",))
    got, _ = ck.restore(template)
    assert _same(got, st)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got.params))


def test_resumed_run_equals_straight_run(tmp_path):
    api = get_model("tinyllama-1.1b", smoke=True, device="cpu")
    tc = TrainConfig(optimizer="adamw", peak_lr=1e-3, total_steps=6, warmup=2)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b, _ in zip(lm_batches(api.cfg.vocab, 2, 32, seed=0), range(6))]
    step = make_train_step(api.loss, tc)
    fresh = lambda: make_train_state(api.init(0), get_optimizer("adamw"), ("blocks",))
    straight = fresh()
    for b in batches:
        straight, _ = step(straight, b)
    half = fresh()
    for b in batches[:3]:
        half, _ = step(half, b)
    ck = Checkpointer(str(tmp_path))
    ck.save(half)
    resumed, meta = ck.restore(make_train_state(api.init(7), get_optimizer("adamw"),
                                                ("blocks",)))
    assert meta["step"] == 3
    for b in batches[3:]:
        resumed, _ = step(resumed, b)
    assert _same(resumed, straight)
