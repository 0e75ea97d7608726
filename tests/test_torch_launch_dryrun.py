"""The port's dry run (``launch/dryrun.py``, ``roofline/counts.py``) against the
JAX package's compiled dry run, on the CPU.

* **Argument bytes.**  The bytes a device holds of a cell's arguments
  (``launch/sharding.py`` ``device_bytes`` over the specs) equal XLA's
  ``memory_analysis().argument_size_in_bytes`` of ``repro.launch.dryrun``'s
  programs compiled for a 2×4 mesh of eight host devices, at a reduced width
  (2 layers, d_model 256): tinyllama's train, prefill and decode cells,
  deepseek-v2's decode (MLA cache, MoE), falcon-mamba's decode and
  seamless' prefill.  The lasso program at 2×2: the port's rank block and
  labels equal XLA's argument bytes of the blocks and labels under the
  program's shardings (XLA's whole figure adds the scalar and key
  arguments it keeps).
* **Collectives.**  At 2×2, one lane, T = 10, n = 256, d = 512, Kc = 16,
  Kr = 8: ``collective_bytes`` of the port's dry run equals
  ``repro.roofline.hlo.collective_bytes_nested`` of ``shard_lowering``'s
  optimized HLO, and ``collective_bytes_flat`` equals the JAX dry run's
  ``collective_bytes`` (a loop body once), by kind, byte for byte.  The two
  JAX programs run in subprocesses (four and eight fake host devices, as
  ``tests/test_distributed_fw.py``).
* **DryMesh.**  ``DryMesh(2, 2)`` records the same (kind, axes, dtype,
  bytes) entries, in order, as rank 0 of a real 2×2 gloo grid
  (``launch/shard.py`` ``run_ranks``) at that shape.
* **FLOPs.**  For every family (dense, MoE/MLA, ssm, hybrid, enc-dec) at
  smoke size, ``step_flops`` on ``meta`` equals ``FlopCounterMode`` over a
  real CPU run, exactly, for train, prefill and decode; and
  ``two_point_total`` from two depths equals the count at a depth of whole
  layer-pattern units.  Flash attention counts its formula, once, on both.
* The CLI: an LM cell on the host, and the paper-lasso cells on the CPU
  (8 collectives a step, bytes a step from the block shapes).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.solvers.jax_shard import dry_block, shard_dry_run
from repro_torch.distributed.block_sparse import block_specs
from repro_torch.distributed.collectives import DryMesh
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import get_model
from repro_torch.roofline.analysis import two_point_total
from repro_torch.roofline.counts import collective_bytes, collective_bytes_flat, step_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
REDUCED = {"n_layers": 2, "d_model": 256}
LM_CASES = [("tinyllama-1.1b", "train_4k", REDUCED),
            ("tinyllama-1.1b", "prefill_32k", REDUCED),
            ("tinyllama-1.1b", "decode_32k", REDUCED),
            ("deepseek-v2-236b", "decode_32k", REDUCED),
            ("falcon-mamba-7b", "decode_32k", REDUCED),
            ("seamless-m4t-medium", "prefill_32k",
             {**REDUCED, "enc_layers": 1, "dec_layers": 1})]
LASSO = dict(n=256, d=512, kc=16, kr=8, steps=10)

XLA_LM = r"""
import json, os, sys
from repro.launch import dryrun as jd          # sets XLA_FLAGS from REPRO_DRYRUN_DEVICES
import jax

def auto_mesh(shape):
    if hasattr(jax.sharding, "AxisType"):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return jax.make_mesh(shape, ("data", "model"))
cases = json.loads(sys.argv[1])
mesh = auto_mesh((2, 4))
out = {}
with mesh:
    for arch, cell, ov in cases:
        jitted, args = jd._build(arch, cell, mesh, [], overrides=ov)
        mem = jitted.lower(*args).compile().memory_analysis()
        out[f"{arch}/{cell}"] = int(mem.argument_size_in_bytes)
print("RESULT" + json.dumps(out))
"""

XLA_LASSO = r"""
import json, sys
from repro.launch import dryrun as jd          # sets XLA_FLAGS from REPRO_DRYRUN_DEVICES
import jax, jax.numpy as jnp
from repro.core.solvers.jax_shard import shard_lowering
from repro.distributed.fw_shard import dist_fw_shardings
from repro.roofline.hlo import collective_bytes_nested
def auto_mesh(shape):
    if hasattr(jax.sharding, "AxisType"):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return jax.make_mesh(shape, ("data", "model"))
p = json.loads(sys.argv[1])
mesh = auto_mesh((2, 2))
with mesh:
    jitted, args = shard_lowering(p["n"], p["d"], mesh, steps=p["steps"], kc=p["kc"], kr=p["kr"])
    comp = jitted.lower(*args).compile()
    b_shd, y_shd = dist_fw_shardings(args[0], mesh)
    total = lambda blocks, y: sum(jnp.sum(x) for x in jax.tree.leaves((blocks, y)))
    held = jax.jit(total, in_shardings=(b_shd, y_shd)).lower(*args[:2]).compile()
hlo = comp.as_text()
print("RESULT" + json.dumps({
    "nested": collective_bytes_nested(hlo), "flat": jd.collective_bytes(hlo),
    "args": int(comp.memory_analysis().argument_size_in_bytes),
    "block_args": int(held.memory_analysis().argument_size_in_bytes),
    "scalar_args": int(sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(args[2:])))}))
"""


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def xla():
    """The JAX package's compiled figures: the LM cells on eight host devices
    and the lasso program on four, in two processes run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", script, json.dumps(arg)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, REPRO_DRYRUN_DEVICES=str(devices)), cwd=ROOT)
             for script, arg, devices in ((XLA_LM, LM_CASES, 8), (XLA_LASSO, LASSO, 4))]
    try:
        return _result(procs[0]), _result(procs[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("arch,cell,overrides", LM_CASES,
                         ids=[f"{a}-{c}" for a, c, _ in LM_CASES])
def test_argument_bytes_equal_xla(xla, arch, cell, overrides):
    mesh = Mesh(("data", "model"), (2, 4))
    args, _ = dryrun._build(arch, cell, mesh, [], overrides=dict(overrides))
    assert sum(shd.device_bytes(t, s, mesh) for t, s in args) == xla[0][f"{arch}/{cell}"]


@pytest.fixture(scope="module")
def lasso_run():
    p = LASSO
    return shard_dry_run(p["n"], p["d"], 2, 2, steps=p["steps"], kc=p["kc"], kr=p["kr"],
                         density=0.02, device="cpu")


def test_lasso_block_bytes_equal_xla(xla, lasso_run):
    held = xla[1]
    assert lasso_run.block_bytes == held["block_args"] == 41_472
    # XLA's whole figure adds the scalar and key arguments it keeps
    assert 0 < held["args"] - held["block_args"] <= held["scalar_args"]


def test_collective_bytes_equal_xla(xla, lasso_run):
    held = xla[1]
    assert collective_bytes(lasso_run.records) == held["nested"] == {
        "all-reduce": 12_704, "all-gather": 80}
    assert collective_bytes_flat(lasso_run) == held["flat"] == {
        "all-reduce": 2_192, "all-gather": 8}
    kinds = [c.kind for c in lasso_run.step]
    assert kinds.count("all-gather") == 1 and kinds.count("all-reduce") == 7
    assert [c.dtype for c in lasso_run.step] == ["float32", "int32", "float32", "int32",
                                                 "float32", "float32", "float32", "int32"]


def test_dry_mesh_records_what_rank_0_of_a_real_grid_sends(lasso_run):
    import pickle
    p = LASSO
    rng = np.random.default_rng(3)
    key = np.unique(rng.integers(0, p["n"] * p["d"], size=int(p["n"] * p["d"] * 0.005)))
    rows, cols = np.divmod(key, p["d"])
    data = {"shape": (p["n"], p["d"]), "rows": rows, "cols": cols,
            "vals": rng.normal(size=rows.size).astype(np.float32),
            "y": rng.integers(0, 2, size=p["n"]).astype(np.float32),
            "kc": p["kc"], "kr": p["kr"], "steps": p["steps"]}
    script = ("import pickle, sys\n"
              "from repro_torch.launch.shard import run_ranks\n"
              "import torch_shard_cases\n"
              "data = pickle.loads(bytes.fromhex(sys.argv[1]))\n"
              "outs = run_ranks(torch_shard_cases.record_collectives, 4, backend='gloo', "
              "timeout_s=240, args=(data,))\n"
              "print('RESULT' + pickle.dumps(outs).hex())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                                       os.path.join(ROOT, "tests")]))
    run = subprocess.run([sys.executable, "-c", script, pickle.dumps(data).hex()],
                         capture_output=True, text=True, timeout=TIMEOUT_S, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT")][0]
    ranks = pickle.loads(bytes.fromhex(line[len("RESULT"):]))
    assert ranks[0]["padding"] == (p["kc"], p["kr"])
    dry = [tuple(c) for c in lasso_run.setup + lasso_run.step * p["steps"] + lasso_run.output]
    assert ranks[0]["records"] == dry
    assert all(r["records"] == dry for r in ranks)


def test_dry_block_has_block_specs_shapes():
    grid, local = block_specs(1000, 3000, 4, 2, 12, 9)
    assert tuple(grid.csc_rows.shape) == (4, 2, 1500, 12) and grid.padded == (1000, 3000)
    blk, y = dry_block(1000, 3000, 4, 2, kc=12, kr=9, density=0.01, seed=1)
    for got, want in zip(blk, local):
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    assert y.shape == (250,) and int((blk.csc_vals != 0).sum()) > 0
    again, _ = dry_block(1000, 3000, 4, 2, kc=12, kr=9, density=0.01, seed=1)
    assert all(torch.equal(a, b) for a, b in zip(blk, again))


def test_dry_mesh_collectives_copy_and_stack():
    rec = []
    mesh = DryMesh(2, 3, recorder=rec)
    x = torch.arange(4, dtype=torch.float32)
    assert torch.equal(mesh.psum(x, ("rows",)), x)
    assert tuple(mesh.all_gather(x, "model").shape) == (3, 4)
    assert [tuple(c) for c in rec] == [("all-reduce", ("rows",), "float32", 16),
                                       ("all-gather", ("model",), "float32", 48)]


FAMILIES = ["tinyllama-1.1b", "deepseek-v2-236b", "falcon-mamba-7b", "recurrentgemma-2b",
            "seamless-m4t-medium"]


def _inputs(cfg, kind, device, b=2, s=32):
    g = np.random.default_rng(0)
    if kind == "decode":
        return {"pos": torch.tensor(5, dtype=torch.int32).to(device),
                "tokens": torch.as_tensor(g.integers(0, cfg.vocab, (b, 1)),
                                          dtype=torch.int32).to(device)}
    out = {"tokens": torch.as_tensor(g.integers(0, cfg.vocab, (b, s)),
                                     dtype=torch.int32).to(device)}
    if cfg.family == "encdec":
        out["frames"] = torch.as_tensor(g.normal(size=(b, s, cfg.d_model)),
                                        dtype=cfg.torch_dtype).to(device)
    return out


def _flops(arch, kind, device, overrides=None, microbatches=1):
    api = get_model(arch, smoke=True, overrides=overrides, device=device)
    params = api.init(0)
    cache = api.init_cache(2, 64) if kind == "decode" else None
    return step_flops(api, kind, params, _inputs(api.cfg, kind, device), cache=cache,
                      microbatches=microbatches)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_flops_on_meta_equal_a_cpu_run(arch, kind):
    mb = 2 if kind == "train" else 1
    cpu = _flops(arch, kind, "cpu", microbatches=mb)
    assert cpu > 0 and _flops(arch, kind, "meta", microbatches=mb) == cpu


# (two depths, a depth of whole pattern units beyond them) a family, as overrides
def _depths(arch):
    cfg = smoke_config(arch)
    if cfg.family == "encdec":
        mk = lambda n: {"n_layers": 2 * n, "enc_layers": n, "dec_layers": n}
        return (2, mk(2)), (4, mk(4)), (6, mk(6))
    n = len(cfg.layer_pattern) or 2
    return tuple((k * n, {"n_layers": k * n}) for k in (1, 2, 3))


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_point_total_equals_the_full_depth(arch):
    for kind in ("train", "prefill"):
        (l1, o1), (l2, o2), (lf, of) = _depths(arch)
        f1, f2, ff = (_flops(arch, kind, "meta", overrides=o) for o in (o1, o2, of))
        assert two_point_total(f1, f2, l1, l2, lf) == ff


def test_flash_ops_count_once_and_launch_nothing_on_meta():
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 16, generator=g) for h in (4, 2, 2))
    want = fa_ops.attention_flops(q.shape, k.shape, v.shape, True, 24)
    assert want == 2 * 2 * 4 * (16 + 16) * fa_ops.keys_seen(64, 64, True, 24)
    before = launch_counts()
    counts = []
    for dev in ("cpu", "meta"):
        qq, kk, vv = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        with FlopCounterMode(display=False) as mode:
            out = fa_ops.flash_attention(qq, kk, vv, causal=True, window=24)
            out.sum().backward()
        assert out.device.type == dev and tuple(out.shape) == (2, 64, 4, 16)
        assert tuple(qq.grad.shape) == tuple(q.shape) and qq.grad.device.type == dev
        counts.append(mode.get_total_flops())
        with torch.no_grad(), FlopCounterMode(display=False) as fwd:
            fa_ops.flash_attention(qq, kk, vv, causal=True, window=24)
        assert fwd.get_total_flops() == want
    assert counts == [want + 5 * want // 2] * 2
    assert launch_counts() == before
    with pytest.raises(ValueError, match="GQA"):
        fa_ops.flash_attention(q.to("meta")[:, :, :3], k.to("meta"), v.to("meta"))


def test_dryrun_cli_cells(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    (cell,) = json.loads(out.read_text())["results"]
    assert cell["mesh"] == "16x16" and cell["flops"] > 0 and cell["bytes_accessed"] is None
    assert cell["collective_bytes"] is None and cell["memory"]["argument_size_in_bytes"] > 0
    assert cell["fallbacks"] == [": dim 1 % ('data',)(16) != 0 → replicated"]

    assert dryrun.main(["--arch", "paper-lasso", "--shape", "rcv1", "--both-meshes",
                        "--device", "cpu", "--out", str(out)]) == 0
    cells = json.loads(out.read_text())["results"]
    assert [c["mesh"] for c in cells] == ["16x16", "2x16x16"]
    for c in cells:
        a, b = c["grid"]
        assert (a * b, c["kc"], c["kr"]) == ((256, 8, 18) if a == 16 else (512, 8, 18))
        assert c["collectives_per_step"] == {"all-gather": 1, "all-reduce": 7}
        # the masses gather (b floats), the winner's index, α_j, rows and values
        # (Kc each), the α delta (D_loc floats), g̃'s dot and j
        assert c["bytes_per_step"] == 4 * b + 4 + 4 + 8 * c["kc"] + 4 * c["d_loc"] + 4 + 4
        assert c["d_loc"] == 2953 and c["n_loc"] == -(-20_242 // a)
        assert c["collective_bytes"]["all-reduce"] == 4 * c["d_loc"] + 50 * (
            c["bytes_per_step"] - 4 * b)
