"""The port's training loss and its gradients against the JAX package's, on the CPU.

Both packages take the same float32 weights (the JAX ``lm_init`` pytree
carried over by ``interop.lm_params``) and the same tokens (numpy, seeded):

* ``ce_loss`` — the logit softcap, a tied head, a padded vocabulary and a
  sequence that is not a multiple of the chunk — value within 1e-6
  (relative), gradients of the hiddens and the head within 1e-5;
* each of the ten archs' smoke ``lm_loss`` (every family: dense, MoE with
  MLA, the selective SSM, the RG-LRU hybrid, the encoder-decoder on its
  ``{"frames", "tokens"}`` batch) within 1e-5 (relative) of
  ``jax.value_and_grad``'s, its gradients within 2e-5 (absolute) + 2e-4
  (relative) of JAX's leaf for leaf in JAX's layout
  (``interop.lm_params_to_numpy``), with remat on and the same loss with it
  off;
* the MoE at a capacity factor that drops lanes, with ``moe_local_groups =
  2`` and with ``moe_combine = "scatter"``: ``moe_apply`` (output, aux,
  dropped share) within 1e-5, and the loss and gradients as above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models.registry import get_model as j_get_model
from repro_torch import interop
from repro_torch.configs import ARCH_IDS
from repro_torch.models import common as cm
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import tree_leaves, tree_unflatten

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
MOE_VARIANTS = {"drops": {"capacity_factor": 0.5},
                "local_groups": {"moe_local_groups": 2, "capacity_factor": 0.75},
                "scatter": {"moe_combine": "scatter", "capacity_factor": 0.75}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}/{i}" if prefix else str(i)).items()}
    return {prefix: np.asarray(tree, np.float32)}


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, s // 2, cfg.d_model)).astype(np.float32)
    return batch


def _port_loss_and_grads(api, tp, batch, remat=True):
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = api.loss(tp, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), interop.lm_params_to_numpy(tree_unflatten(tp, grads), api.cfg)


def _check_against_jax(arch, overrides=None, seed=0):
    japi = j_get_model(arch, smoke=True, overrides=overrides)
    jp = japi.init(jax.random.PRNGKey(seed))
    api = get_model(arch, smoke=True, overrides=overrides, device="cpu")
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")
    batch = _batch(api.cfg, seed)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})))(jp)
    loss, grads = _port_loss_and_grads(api, tp, batch)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    got, want = _flat(grads), _flat(j_grads)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{arch} {overrides}: d loss / d {key}")
    return api, tp, batch, loss


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_grads_match_jax(arch):
    api, tp, batch, loss = _check_against_jax(arch)
    # remat recomputes the same blocks: the same loss without it
    off, _ = _port_loss_and_grads(api, tp, batch, remat=False)
    np.testing.assert_allclose(off, loss, rtol=1e-6)


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
def test_moe_training_variants_match_jax(variant):
    over = MOE_VARIANTS[variant]
    _check_against_jax("deepseek-v2-236b", overrides=over, seed=1)
    # the layer alone: output, aux term and dropped share
    japi = j_get_model("deepseek-v2-236b", smoke=True, overrides=over)
    api = get_model("deepseek-v2-236b", smoke=True, overrides=over, device="cpu")
    jp = japi.init(jax.random.PRNGKey(2))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")
    x = np.random.default_rng(3).normal(size=(64, api.cfg.d_model)).astype(np.float32)
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    y_j, aux_j = jcm.moe_apply(jmoe, jnp.asarray(x), japi.cfg)
    y, aux = cm.moe_apply(tp["blocks"][0]["moe"], torch.from_numpy(x), api.cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for name in ("moe_aux", "dropped"):
        np.testing.assert_allclose(float(aux[name]), float(aux_j[name]), rtol=1e-5, atol=1e-7)
    assert float(aux["dropped"]) > 0.0          # the capacity drops lanes


@pytest.mark.parametrize("tied,softcap,vocab,padded,s,chunk", [
    (False, 0.0, 48, 48, 64, 16),          # whole chunks
    (False, 30.0, 40, 48, 40, 16),         # softcap, padded vocab, a ragged last chunk
    (True, 0.0, 40, 48, 37, 16),           # tied head, ragged
    (True, 5.0, 48, 48, 20, 256),          # one chunk shorter than chunk_seq
])
def test_ce_loss_matches_jax(tied, softcap, vocab, padded, s, chunk):
    rng = np.random.default_rng(4)
    b, d = 2, 16
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = rng.normal(size=(padded, d) if tied else (d, padded)).astype(np.float32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s) < s - 1)[None, :]
    kw = dict(tied=tied, logit_softcap=softcap, chunk_seq=chunk)
    j_loss, (jdx, jdh) = jax.value_and_grad(
        lambda a, h: jcm.ce_loss(a, h, jnp.asarray(targets), jnp.asarray(mask), vocab, padded,
                                 **kw), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    loss = cm.ce_loss(tx, th, torch.from_numpy(targets), torch.from_numpy(mask), vocab, padded,
                      **kw)
    dx, dh = torch.autograd.grad(loss, (tx, th))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-5, rtol=1e-5)
