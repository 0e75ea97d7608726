"""The port's optimizers, schedules, trainer and loader against the JAX package's, on the CPU.

* ``adamw`` and ``adafactor`` fed the *same* gradients (numpy, seeded) for
  four steps, on a tree with a stacked layer group, against JAX's within
  1e-6 (absolute and relative): parameters and state, leaf for leaf in
  JAX's layout (``interop.opt_state_to_numpy``); the state carried in from
  JAX (``interop.opt_state``) continues as JAX does;
* the schedules (``wsd``, ``cosine``, ``constant``) at every step of a
  100-step run within 1e-6 (relative, and 1e-6 of the peak lr absolute:
  float32 ``cos`` rounds differently in the two packages) of JAX's;
* ``clip_by_global_norm``, four microbatches ≡ one batch (JAX's bound:
  2e-4 relative, 2e-5 absolute), the NaN step skipped with the parameters
  and the state kept;
* one ``make_train_step`` step on tinyllama's smoke config against JAX's:
  loss within 1e-5 (relative), ``grad_norm`` within 1e-4 (relative), ``lr``
  equal, and each gradient within 2e-5 (absolute) + 2e-4 (relative);
* the 60-step loss-falls test as JAX's (``tests/test_trainer_data.py``);
* ``lm_batches`` gives the JAX stream's tokens and frames exactly;
* ``ShardedLoader``'s close and drain cases (``tests/test_trainer_data.py``),
  and a finite stream longer than its queue ends.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_model as j_get_model
from repro.train import optimizer as jopt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import TrainState as JTrainState
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import lm_batches
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import clip_by_global_norm, get_optimizer, make_schedule
from repro_torch.train.trainer import (TrainConfig, make_train_state, make_train_step,
                                       tree_leaves, tree_unflatten)

OPT_TOL = 1e-6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}/{i}" if prefix else str(i)).items()}
    return {prefix: np.asarray(tree)}


def _jax_tree(rng):
    """A tree with a stacked group of 3 layers (JAX's layout)."""
    return {"embed": rng.normal(size=(10, 4)).astype(np.float32),
            "final_norm": rng.normal(size=(4,)).astype(np.float32),
            "blocks": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
                       "ln": rng.normal(size=(3, 5)).astype(np.float32),
                       "experts": rng.normal(size=(3, 2, 4, 5)).astype(np.float32)}}


def _port_tree(jt):
    """The same tree in the port's layout: the group as a list of layers."""
    t = {k: torch.from_numpy(v.copy()) for k, v in jt.items() if k != "blocks"}
    t["blocks"] = [{k: torch.from_numpy(v[i].copy()) for k, v in jt["blocks"].items()}
                   for i in range(3)]
    return t


def _stack(port):
    out = {k: v.numpy() for k, v in port.items() if k != "blocks"}
    out["blocks"] = {k: np.stack([layer[k].numpy() for layer in port["blocks"]])
                     for k in port["blocks"][0]}
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_jax_on_the_same_gradients(name):
    rng = np.random.default_rng(0)
    jp = _jax_tree(rng)
    tp = _port_tree(jp)
    jo, po = jopt.get_optimizer(name), get_optimizer(name)
    jp_j = jax.tree.map(jnp.asarray, jp)
    js, ps = jo.init(jp_j), po.init(tp, ("blocks",))
    for step in range(4):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
        lr = 1e-2 * (step + 1)
        jp_j, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp_j, lr)
        po.update(_port_tree(g), ps, tp, lr, ("blocks",))
    got_p, want_p = _flat(_stack(tp)), _flat(jax.tree.map(np.asarray, jp_j))
    assert sorted(got_p) == sorted(want_p)
    for key in want_p:
        np.testing.assert_allclose(got_p[key], want_p[key], rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=key)
    got_s = _flat(interop.opt_state_to_numpy(ps))
    want_s = _flat(jax.tree.map(np.asarray, js))
    assert sorted(got_s) == sorted(want_s)
    for key in want_s:
        assert got_s[key].shape == want_s[key].shape, key
        np.testing.assert_allclose(got_s[key], want_s[key], rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=key)
    # JAX's state carried into the port continues as JAX does
    carried = interop.opt_state(jax.tree.map(np.asarray, js), "cpu")
    tp2 = _port_tree(jax.tree.map(np.asarray, jp_j))
    g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
    jp_j, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp_j, 0.05)
    po.update(_port_tree(g), carried, tp2, 0.05, ("blocks",))
    for key, want in _flat(jax.tree.map(np.asarray, jp_j)).items():
        np.testing.assert_allclose(_flat(_stack(tp2))[key], want, rtol=OPT_TOL, atol=OPT_TOL)


@pytest.mark.parametrize("kind", ["cosine", "wsd", "constant"])
def test_schedules_match_jax_at_every_step(kind):
    ours = make_schedule(kind, peak_lr=1e-3, total_steps=100, warmup=10)
    theirs = jopt.make_schedule(kind, peak_lr=1e-3, total_steps=100, warmup=10)
    got = np.array([ours(s) for s in range(100)])
    want = np.array([float(theirs(jnp.asarray(s))) for s in range(100)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 1e-3)
    assert got[0] > 0.0 and got.max() <= 1e-3 * 1.0001


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.sqrt((clipped["a"] ** 2).sum())) == pytest.approx(1.0, rel=1e-5)
    kept, _ = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(kept["a"], torch.full((4,), 0.1))


def _quadratic_state(w, opt="adamw"):
    return make_train_state({"w": torch.tensor(w)}, get_optimizer(opt))


def test_nan_step_skipped():
    def loss_fn(p, batch, remat=True):
        return torch.mean((p["w"] * batch["x"]) ** 2)
    step = make_train_step(loss_fn, TrainConfig(optimizer="adamw", peak_lr=0.1,
                                                total_steps=10, warmup=1))
    state = _quadratic_state([1.0, 2.0])
    m0 = {k: v.clone() for k, v in state.opt_state["m"].items()}
    state, m = step(state, {"x": torch.tensor([float("nan"), 1.0])})
    assert m["skipped"] == 1.0 and int(state.step) == 1
    assert torch.equal(state.params["w"].detach(), torch.tensor([1.0, 2.0]))
    assert int(state.opt_state["count"]) == 0
    assert all(torch.equal(state.opt_state["m"][k], v) for k, v in m0.items())
    state, m = step(state, {"x": torch.tensor([1.0, 1.0])})
    assert m["skipped"] == 0.0 and int(state.opt_state["count"]) == 1


def test_microbatch_equivalence():
    def loss_fn(p, batch, remat=True):
        return torch.mean((batch["x"] @ p["w"]) ** 2)
    w = np.random.default_rng(0).normal(size=(6, 1)).astype(np.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32))
    outs = []
    for mb in (1, 4):
        step = make_train_step(loss_fn, TrainConfig(optimizer="adamw", peak_lr=0.01,
                                                    total_steps=10, warmup=1, microbatches=mb))
        state, _ = step(make_train_state({"w": torch.from_numpy(w.copy())},
                                         get_optimizer("adamw")), {"x": x})
        outs.append(state.params["w"].detach().numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-5)


def test_train_step_learns():
    step = make_train_step(lambda p, b, remat=True: torch.mean((p["w"] - b["target"]) ** 2),
                           TrainConfig(optimizer="adamw", peak_lr=0.1, total_steps=200,
                                       warmup=1, schedule="constant"))
    state = _quadratic_state([4.0, 4.0])
    for _ in range(200):
        state, m = step(state, {"target": torch.tensor([1.0, -1.0])})
    assert m["loss"] < 0.1


def test_one_lm_step_matches_jax():
    arch = "tinyllama-1.1b"
    japi = j_get_model(arch, smoke=True)
    api = get_model(arch, smoke=True, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tc_kw = dict(optimizer="adamw", peak_lr=1e-3, total_steps=60, warmup=5)
    batch = next(lm_batches(api.cfg.vocab, 4, 32, seed=0))
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                         opt_state=jopt.get_optimizer("adamw").init(jp))
    _, jm = jax.jit(j_make_train_step(japi.loss, JTrainConfig(**tc_kw)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    j_grads = jax.grad(lambda p: japi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)

    tp = interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")
    state = make_train_state(tp, get_optimizer("adamw"), ("blocks",))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(api.loss(state.params, tb), leaves)
    got_g = _flat(interop.lm_params_to_numpy(tree_unflatten(state.params, grads), api.cfg))
    for key, want in _flat(jax.tree.map(np.asarray, j_grads)).items():
        np.testing.assert_allclose(got_g[key], want, rtol=2e-4, atol=2e-5, err_msg=key)
    state, m = make_train_step(api.loss, TrainConfig(**tc_kw))(state, tb)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    assert m["lr"] == float(jm["lr"]) and m["skipped"] == float(jm["skipped"]) == 0.0
    assert int(state.step) == 1 and int(state.opt_state["count"]) == 1


def test_lm_smoke_training_loss_decreases():
    """60 steps on the Markov stream beat the initial loss (JAX's test)."""
    api = get_model("tinyllama-1.1b", smoke=True, device="cpu")
    state = make_train_state(api.init(0), get_optimizer("adamw"), ("blocks",))
    step = make_train_step(api.loss, TrainConfig(optimizer="adamw", peak_lr=1e-3,
                                                 total_steps=60, warmup=5))
    stream = lm_batches(api.cfg.vocab, 8, 32, seed=0)
    losses = []
    for _ in range(60):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(stream).items()})
        losses.append(m["loss"])
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.3


def test_lm_batches_take_the_jax_streams_tokens_and_frames():
    """The vectorised sampler draws the JAX package's stream: tokens at a
    full vocabulary and frames, three batches in a row, equal exactly."""
    from repro.data.synthetic import lm_batches as j_lm_batches
    for args in ((32000, 4, 96, 0, None), (50, 8, 64, 4, 12)):
        ours, theirs = lm_batches(*args), j_lm_batches(*args)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])


def test_sharded_loader_close_unblocks_full_queue():
    def infinite():
        while True:
            yield np.zeros(2)

    ld = ShardedLoader(infinite(), device="cpu", prefetch=1)
    assert torch.equal(next(ld), torch.zeros(2, dtype=torch.float64))
    time.sleep(0.2)               # let it fill the queue and block on put
    ld.close()
    assert not ld.thread.is_alive()
    with pytest.raises(StopIteration):
        next(ld)


def test_sharded_loader_ends_a_finite_stream_longer_than_its_queue():
    """The end marker waits for room: a stream of more batches than the
    queue holds ends (the JAX loader drops the marker on a full queue)."""
    ld = ShardedLoader(iter([np.full(2, i) for i in range(5)]), device="cpu", prefetch=1)
    got = [int(t[0]) for t in ld]
    ld.close()
    assert got == [0, 1, 2, 3, 4] and not ld.thread.is_alive()


def test_sharded_loader_drains_finite_iterator():
    ld = ShardedLoader(iter([{"tokens": np.ones((2, 3), np.int32)},
                             {"tokens": np.zeros((2, 3), np.int32)}]), device="cpu", prefetch=4)
    got = list(ld)
    assert len(got) == 2 and all(isinstance(b["tokens"], torch.Tensor) for b in got)
    assert got[0]["tokens"].dtype == torch.int32 and int(got[0]["tokens"].sum()) == 6
    ld.close()
    assert not ld.thread.is_alive()
