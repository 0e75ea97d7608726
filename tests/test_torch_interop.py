"""State carried from the JAX package into the port, and import purity.

* Carry: JAX runs 10 steps; its ``FWCarry`` goes through
  ``repro_torch.interop`` and the port runs 10 more from ``t0=10``; the
  port's steps must be JAX's steps 11-20 of one 20-step run (coordinates
  exactly, gaps and the final w within atol 1e-4, the cross-engine
  contract).
* LM weights: ``lm_params`` carries an MoE config's leading dense layers
  and its expert stacks, each layer's ``(E, d, f)``, bit for bit in bf16,
  with the router kept in float32; and mamba's, rglru's and encdec's
  pytrees, one dict a layer.
* Import purity: importing the port, the whole slice and ``chip_smoke``
  leaves ``jax`` and ``repro`` out of ``sys.modules``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers.jax_sparse import (em_scale_for, fw_carry_init_jit,
                                           fw_scan_chunk_jit, fw_setup_jit)
from repro.configs import smoke_config as j_smoke_config
from repro.core.sparse import formats as jf
from repro.data.synthetic import make_sparse_classification
from repro_torch import interop
from repro_torch.core.solvers.torch_sparse import fw_scan_chunk, fw_setup

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return jf.host_to_padded(X), y


def _fields(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _pair_fields(pcsr, pcsc):
    names = ("indices", "values", "nnz")
    return ({**_fields(pcsr, names), "shape": pcsr.shape},
            {**_fields(pcsc, names), "shape": pcsc.shape})


def _carry_fields(carry):
    f = _fields(carry, ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha", "key", "done",
                        "stop_at"))
    s = carry.sampler
    f["sampler"] = _fields(s, ("v", "c")) if hasattr(s, "c") else _fields(s, ("p", "bound"))
    return f


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", ["logistic", "lad"])
def test_jax_carry_resumes_in_the_port(problem, loss, private):
    (pcsr, pcsc), y = problem
    n, d = pcsr.shape
    y32 = jnp.asarray(y, jnp.float32)
    queue = "two_level" if private else "group_argmax"
    em = em_scale_for(JaxConfig(steps=20, queue=queue), n)
    y_scan = None if loss == "logistic" else y32
    setup = fw_setup_jit(pcsr, y32, loss=loss, interpret=True)
    kw = dict(loss=loss, private=private, fused=True, interpret=True)

    def run(steps, carry, t0):
        return fw_scan_chunk_jit(pcsr, pcsc, carry, 8.0, em, 0.0, t0, y_scan, steps=steps,
                                 **kw)

    carry0 = fw_carry_init_jit(d, jnp.float32, *setup, em, jax.random.PRNGKey(0),
                               private=private)
    full, (gaps20, coords20) = run(20, carry0, 0)
    half, _ = run(10, carry0, 0)

    csr_f, csc_f = _pair_fields(pcsr, pcsc)
    tr, tc = interop.padded_csr(csr_f, "cpu"), interop.padded_csc(csc_f, "cpu")
    carry = interop.fw_carry(_carry_fields(half), d, "cpu")
    y_t = None if loss == "logistic" else torch.from_numpy(np.asarray(y, np.float32))
    carry, (gaps, coords) = fw_scan_chunk(tr, tc, carry, 8.0, em, 0.0, 10, y_t, steps=10,
                                          loss=loss, private=private)
    msg = f"{loss} private={private}"
    np.testing.assert_array_equal(coords.numpy(), np.asarray(coords20)[10:], err_msg=msg)
    np.testing.assert_allclose(gaps.numpy(), np.asarray(gaps20)[10:], atol=1e-4, err_msg=msg)
    w_ref = np.asarray(full.w * full.w_m)
    np.testing.assert_allclose((carry.w * carry.w_m).numpy(), w_ref, atol=1e-4, err_msg=msg)
    back = interop.carry_to_numpy(carry)
    np.testing.assert_array_equal(back["key"], np.asarray(full.key), err_msg=msg)
    np.testing.assert_allclose(back["alpha"], np.asarray(full.alpha), atol=1e-5, err_msg=msg)


def test_interop_round_trips_setup_and_tiered(problem):
    (pcsr, pcsc), y = problem
    setup = fw_setup_jit(pcsr, jnp.asarray(y, jnp.float32), loss="logistic", interpret=True)
    tr = interop.padded_csr(_pair_fields(pcsr, pcsc)[0], "cpu")
    tc = interop.padded_csc(_pair_fields(pcsr, pcsc)[1], "cpu")
    ours = fw_setup(tr, torch.from_numpy(np.asarray(y, np.float32)), loss="logistic", pcsc=tc)
    for a, b in zip(interop.setup_state(setup, "cpu"), ours):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    tiered = jf.tiered_from_padded(pcsc, 8)
    names = ("indices", "values", "nnz", "heavy_slot", "heavy_indices", "heavy_values")
    tt = interop.tiered_csc({**_fields(tiered, names), "shape": tiered.shape}, "cpu")
    for name in names:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tiered, name)))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_lm_params_carries_lead_blocks_expert_stacks_and_router(arch):
    from repro.models.transformer import lm_init
    cfg = dataclasses.replace(j_smoke_config(arch), dtype="bfloat16", n_layers=3)
    jp = lm_init(jax.random.PRNGKey(0), cfg)
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert len(tp["lead_blocks"]) == 1 and len(tp["blocks"]) == 2
    assert "ffn" in tp["lead_blocks"][0] and "moe" in tp["blocks"][0]
    for layer in range(2):
        moe, jmoe = tp["blocks"][layer]["moe"], jp["blocks"]["moe"]
        for name in ("w1", "w2", "w3"):
            assert moe[name].shape == jmoe[name].shape[1:]           # (E, d, f)
            assert moe[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(moe[name].float().numpy(),
                                          np.asarray(jmoe[name][layer], np.float32))
        assert moe["router"].dtype == torch.float32
        np.testing.assert_array_equal(moe["router"].numpy(), np.asarray(jmoe["router"][layer]))
        np.testing.assert_array_equal(moe["shared"]["w2"].float().numpy(),
                                      np.asarray(jmoe["shared"]["w2"][layer], np.float32))
    np.testing.assert_array_equal(tp["lead_blocks"][0]["ffn"]["w1"].float().numpy(),
                                  np.asarray(jp["lead_blocks"]["ffn"]["w1"][0], np.float32))
    with pytest.raises(ValueError, match="lead_blocks"):
        interop.lm_params(jax.tree.map(np.asarray, jp),
                          dataclasses.replace(cfg, first_dense_layers=2), "cpu")


@pytest.mark.parametrize("arch,groups", [("falcon-mamba-7b", {"blocks": 2}),
                                         ("seamless-m4t-medium",
                                          {"enc_blocks": 2, "dec_blocks": 2}),
                                         ("recurrentgemma-2b", {})])
def test_lm_params_carries_the_other_families(arch, groups):
    """mamba's and encdec's stacked layers become one dict a layer, rglru's
    per-layer list stays a list; bf16 bits and float32 leaves as they are."""
    from repro.models.registry import get_model as j_get_model
    cfg = dataclasses.replace(j_smoke_config(arch), dtype="bfloat16")
    jp = j_get_model(arch, smoke=True, overrides={"dtype": "bfloat16"}).init(
        jax.random.PRNGKey(0))
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert set(tp) == set(jp)
    layers = {name: [(jax.tree.map(lambda a: a[i], jp[name]), tp[name][i]) for i in range(n)]
              for name, n in groups.items()}
    if not groups:                                   # rglru: "rra"
        assert [sorted(b) for b in tp["blocks"]] == [["kind_r", "mlp"]] * 2 + [["kind_a", "mlp"]]
        layers = {"blocks": list(zip(jp["blocks"], tp["blocks"]))}
    for name, pairs in layers.items():
        assert len(tp[name]) == len(pairs)
        for jlayer, layer in pairs:
            flat, jflat = jax.tree.leaves(layer), jax.tree.leaves(jlayer)
            assert len(flat) == len(jflat)
            for ours, theirs in zip(flat, jflat):
                theirs = np.asarray(theirs)
                assert tuple(ours.shape) == theirs.shape
                assert (ours.dtype == torch.bfloat16) == (theirs.dtype.name == "bfloat16")
                np.testing.assert_array_equal(ours.float().numpy(), theirs.astype(np.float32))
    with pytest.raises(ValueError, match="layers"):
        interop.lm_params(jax.tree.map(np.asarray, jp),
                          dataclasses.replace(cfg, n_layers=4, enc_layers=3, dec_layers=3), "cpu")


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = (
        "import sys, importlib\n"
        "sys.path.insert(0, 'src')\n"
        "mods = ['repro_torch', 'repro_torch.interop', 'repro_torch.prng',\n"
        "        'repro_torch.core.solvers.torch_sparse', 'repro_torch.core.solvers.backends',\n"
        "        'repro_torch.core.solvers.stopping', 'repro_torch.core.fw_dense',\n"
        "        'repro_torch.core.solvers.screening', 'repro_torch.core.solvers.path',\n"
        "        'repro_torch.kernels', 'repro_torch.data.synthetic',\n"
        "        'repro_torch.configs', 'repro_torch.configs.tinyllama_1_1b',\n"
        "        'repro_torch.configs.llama3_2_1b', 'repro_torch.models.config',\n"
        "        'repro_torch.configs.minicpm_2b', 'repro_torch.configs.nemotron_4_15b',\n"
        "        'repro_torch.configs.chameleon_34b', 'repro_torch.configs.deepseek_v2_236b',\n"
        "        'repro_torch.configs.kimi_k2_1t_a32b', 'repro_torch.models.mamba',\n"
        "        'repro_torch.configs.falcon_mamba_7b', 'repro_torch.models.rglru',\n"
        "        'repro_torch.configs.recurrentgemma_2b', 'repro_torch.models.encdec',\n"
        "        'repro_torch.configs.seamless_m4t_medium',\n"
        "        'repro_torch.models.flash', 'repro_torch.models.common',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.registry',\n"
        "        'repro_torch.kernels.flash_attention.ref', 'repro_torch.serve.engine',\n"
        "        'repro_torch.launch.serve', 'chip_smoke']\n"
        "for m in mods: importlib.import_module(m)\n"
        "import repro_torch\n"
        "repro_torch.available_backends()\n"
        "import torch\n"
        "from repro_torch.models.registry import get_model\n"
        "api = get_model('tinyllama-1.1b', smoke=True, device='cpu')\n"
        "api.forward(api.init(0), torch.ones(1, 4, dtype=torch.long))\n"
        "for arch in ('deepseek-v2-236b', 'falcon-mamba-7b', 'recurrentgemma-2b',\n"
        "             'seamless-m4t-medium'):\n"
        "    api = get_model(arch, smoke=True, device='cpu')\n"
        "    api.forward(api.init(0), torch.ones(1, 4, dtype=torch.long))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
