"""The sharded engine on a 2×2 grid: the port over gloo against the JAX
package over four host devices, on the CPU.

Two subprocesses, each with its own timeout, run once for the module:

  * the port: four ranks spawned by ``repro_torch.launch.shard.run_ranks``
    (gloo, ``init_process_group`` with a timeout, so a dead rank fails the
    run and does not hang it), each running ``torch_shard_cases.run``;
  * the JAX package: one process with ``--xla_force_host_platform_device_count=4``
    (as ``tests/test_distributed_fw.py``), three programs at n = 120,
    d = 400, T = 60: argmax (masked, run with and without ``gap_tol``),
    gumbel, and argmax with ``compress_topk = 8``.

The contract: coordinates equal, ``w`` and the gaps within ``atol = 1e-4``
(the g̃ psum over four ranks adds in the collective's order, which may
differ from XLA's by a few float32 ulps, well inside the bound).  Every rank
must return the same bits (each gets the whole result).  The registry solve
takes ``host_sparse``'s coordinates; a ``solve_many`` mesh group equals its
configs' own solves; a store solve (rank 0 builds the blocks cache, the
others load it) equals the in-memory one; a ``mesh=(2, 2)`` config passes
``check_supported``, ``choose_backend`` and ``FitService`` admission.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.data.synthetic import make_sparse_classification

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 420
ATOL = 1e-4

PORT_SCRIPT = r"""
import pickle, sys
from repro_torch.launch.shard import run_ranks
import torch_shard_cases
data = pickle.load(open(sys.argv[1], "rb"))
outs = run_ranks(torch_shard_cases.run, 4, backend="gloo", timeout_s=300, args=(data,))
pickle.dump(outs, open(sys.argv[2], "wb"))
"""

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.data.synthetic import make_sparse_classification
from repro.distributed.block_sparse import build_block_sparse
from repro.distributed.fw_shard import DistFWConfig, build_dist_fw

LAM, STEPS, GAP_TOL, TOPK = 8.0, 60, 3e-3, 8
X, y, _ = make_sparse_classification(n=120, d=400, nnz_per_row=10, informative=15, seed=5)
if hasattr(jax.sharding, "AxisType"):
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
else:
    mesh = jax.make_mesh((2, 2), ("data", "model"))
blocks = build_block_sparse(X, 2, 2)
y_pad = jnp.zeros(blocks.padded[0], jnp.float32).at[:len(y)].set(jnp.asarray(y, jnp.float32))
em = DistFWConfig(lam=LAM, steps=STEPS, selection="gumbel", epsilon=1.0).em_scale(X.shape[0])
out = {}
runs = (("argmax", dict(selection="argmax", early_stop=True), 1.0, 0.0),
        ("gap_tol", dict(selection="argmax", early_stop=True), 1.0, GAP_TOL),
        ("gumbel", dict(selection="gumbel"), em, 0.0),
        ("topk", dict(selection="argmax", compress_topk=TOPK), 1.0, 0.0))
progs = {}
with mesh:
    for name, kw, scale, tol in runs:
        key = tuple(sorted(kw.items()))
        if key not in progs:
            progs[key] = build_dist_fw(blocks, mesh, steps=STEPS, **kw)
        w, gaps, coords, stop = progs[key].whole(
            blocks, y_pad, jnp.float32(LAM), jnp.float32(scale), jnp.float32(tol),
            jax.random.PRNGKey(0))
        out[name] = {"w": np.asarray(w).tolist(), "gaps": np.asarray(gaps).tolist(),
                     "coords": np.asarray(coords).tolist(), "stop_step": int(stop)}
out["programs"] = len(progs)
print("RESULT" + json.dumps(out))
"""


def _problem():
    return make_sparse_classification(n=120, d=400, nnz_per_row=10, informative=15, seed=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's four ranks' outputs, the JAX 2×2 outputs, the problem)."""
    import pickle

    from repro_torch.core.sparse.formats import HostCSR
    from repro_torch.data.store import DatasetStore
    tmp = tmp_path_factory.mktemp("shard2x2")
    X, y, _ = _problem()
    DatasetStore.from_arrays(str(tmp / "store"), HostCSR(X.indptr, X.indices, X.data, X.shape),
                             y, rows_per_shard=48)
    data = {"indptr": X.indptr, "indices": X.indices, "data": X.data, "shape": X.shape,
            "y": np.asarray(y, np.float64), "store": str(tmp / "store")}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    port = subprocess.run([sys.executable, "-c", PORT_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=env, cwd=ROOT)
    assert port.returncode == 0, port.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    jax_env = dict(env, JAX_PLATFORMS="cpu")
    jx = subprocess.run([sys.executable, "-c", JAX_SCRIPT], capture_output=True, text=True,
                        timeout=TIMEOUT_S, env=jax_env, cwd=ROOT)
    assert jx.returncode == 0, jx.stderr[-4000:]
    line = [ln for ln in jx.stdout.splitlines() if ln.startswith("RESULT")][0]
    return ranks, json.loads(line[len("RESULT"):]), (X, y)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, z) for x, z in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return a == b


def _agree(port, ref):
    np.testing.assert_array_equal(port["coords"], np.asarray(ref["coords"]))
    np.testing.assert_allclose(port["w"], np.asarray(ref["w"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port["gaps"], np.asarray(ref["gaps"]), atol=ATOL, rtol=0)
    assert port["stop_step"] == ref["stop_step"]


def test_every_rank_returns_the_same_bits(runs):
    ranks, _, _ = runs
    assert len(ranks) == 4
    for other in ranks[1:]:
        assert _same(ranks[0], other)


@pytest.mark.parametrize("case", ["argmax", "gumbel", "topk", "gap_tol"])
def test_2x2_matches_the_jax_package(runs, case):
    ranks, jx, _ = runs
    assert jx["programs"] == 3
    _agree(ranks[0][case], jx[case])
    if case == "gumbel":
        assert len(set(ranks[0][case]["coords"].tolist())) > 10       # the mechanism explores
    if case == "gap_tol":
        stop = ranks[0][case]["stop_step"]
        assert 0 < stop < 60
        np.testing.assert_array_equal(ranks[0][case]["coords"][:stop],
                                      ranks[0]["argmax"]["coords"][:stop])
        assert (ranks[0][case]["coords"][stop:] == -1).all()
    if case == "topk":
        assert np.abs(ranks[0][case]["w"]).sum() <= 8.0 * (1 + 1e-5)


def test_2x2_registry_solve_takes_host_sparse_coordinates(runs):
    from repro_torch import FWConfig, solve
    from repro_torch.core.sparse.formats import HostCSR
    ranks, _, (X, y) = runs
    host = solve(HostCSR(X.indptr, X.indices, X.data, X.shape), y,
                 FWConfig(backend="host_sparse", lam=8.0, steps=60, device="cpu"))
    reg = ranks[0]["registry"]
    np.testing.assert_array_equal(reg["coords"], host.coords.numpy())
    np.testing.assert_allclose(reg["w"], host.w.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(reg["gaps"], host.gaps.numpy(), atol=ATOL, rtol=0)
    assert reg["stop_step"] == 60


def test_2x2_solve_many_group_equals_its_own_solves(runs):
    ranks, _, _ = runs
    assert _same(ranks[0]["sweep"], ranks[0]["sweep_own"])


def test_2x2_store_solve_builds_the_blocks_cache_on_rank_0(runs):
    ranks, _, _ = runs
    assert ranks[0]["blocks_cache"]
    assert _same(ranks[0]["store"], ranks[0]["store_memory"])


def test_2x2_mesh_config_is_admitted_and_planned(runs):
    ranks, _, _ = runs
    out = ranks[0]
    assert out["auto_backend"] == "jax_shard"
    assert out["service_status"] == ["done", "done"]
    assert _same(out["service"], out["service_own"])
    assert out["service_charged"] == out["service_expected_charge"] > 0
