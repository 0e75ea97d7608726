"""The sharded engine (``jax_shard``) of the port on a 1×1 grid, in process,
against the JAX package (``tests/test_jax_shard.py``'s cases).

On a 1×1 grid every collective is the identity, so the engine must take
the single-device engines' coordinates exactly:

  * non-private: ``host_sparse``'s (the port's float64 host loop, itself
    JAX's), and the JAX package's ``jax_shard``;
  * private: the port's straight-line oracle ``distributed/reference.py``
    and the JAX package's (same key stream, same exponential-mechanism
    draws), for each of the five losses.

The contract is the repo's: coordinates equal, ``w`` and the gaps within
``atol = 1e-4``.  Also here: ``prng.fold_in`` against ``jax.random.fold_in``
bit for bit; the block layout against JAX's arrays exactly (1×1, 2×2, 1×3,
whole-matrix and store-streamed) and the blocks cache across packages; the
selection helpers (``logsumexp``, ``top_k``'s tie rule) against JAX; lanes
(a ``solve_many`` group) against each config's own solve bit for bit; a
store and a ``DatasetRef`` solve with the blocks cache; ``FitService``; the
EM-scale semantics; a world-size-1 process group (collectives through
``torch.distributed``) against no group.  The 2×2 grid is in
``tests/test_torch_shard_dist.py``.
"""
import dataclasses
import datetime
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import OBJECTIVES
from repro_torch import FWConfig, grid, prng, solve, solve_many
from repro_torch.core.solvers import available_backends, get_backend, resolve_queue
from repro_torch.core.sparse.formats import HostCSR

LOSSES = sorted(OBJECTIVES)
ATOL = 1e-4


@pytest.fixture(scope="module")
def shard_problem():
    from repro.data.synthetic import make_sparse_classification
    X, y, _ = make_sparse_classification(n=120, d=400, nnz_per_row=10, informative=15, seed=5)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _cfg(**kw):
    return FWConfig(backend="jax_shard", device="cpu", **kw)


def _y_pad(y, n_pad):
    out = np.zeros(n_pad, np.float32)
    out[:len(y)] = y
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# threefry's fold_in, the block layout and its caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
def test_fold_in_matches_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    for _ in range(20):
        key, sub = jax.random.split(key)
        for data in (0, 1, 2, 3, 255, 2 ** 16 + 5, 2 ** 31 - 1, 2 ** 32 - 1):
            want = np.asarray(jax.random.fold_in(sub, data)).tolist()
            assert list(prng.fold_in(np.asarray(sub).tolist(), data)) == want


@pytest.mark.parametrize("a,b", [(1, 1), (2, 2), (1, 3)])
def test_block_layout_equals_jax_arrays(shard_problem, a, b):
    from repro.distributed.block_sparse import build_block_sparse as jax_blocks
    from repro_torch.distributed import build_block_sparse
    X, host, _ = shard_problem
    got, want = build_block_sparse(host, a, b), jax_blocks(X, a, b)
    assert got.grid == (a, b) and got.shape == want.shape and got.padded == want.padded
    for part in ("csc_rows", "csc_vals", "csr_cols", "csr_vals"):
        np.testing.assert_array_equal(getattr(got, part).numpy(), np.asarray(getattr(want, part)))
    assert got.waste == pytest.approx(want.waste)


def test_store_streamed_blocks_equal_whole_matrix_blocks(shard_problem, tmp_path):
    from repro_torch.data.store import DatasetStore
    from repro_torch.distributed import build_block_sparse
    from repro_torch.distributed.ingest import ShardSource, blocks_from_store
    _, host, y = shard_problem
    store = DatasetStore.from_arrays(str(tmp_path / "s"), host, y, rows_per_shard=48)
    for a, b in ((1, 1), (2, 3)):
        whole = build_block_sparse(host, a, b)
        for got in (blocks_from_store(store, a, b),              # cold: builds and saves
                    DatasetStore.open(store.root).blocks_load(a, b),   # warm
                    ShardSource.from_any(store).blocks(a, b)):
            for part in ("csc_rows", "csc_vals", "csr_cols", "csr_vals"):
                assert torch.equal(getattr(got, part), getattr(whole, part))
            assert (got.shape, got.padded) == (whole.shape, whole.padded)


def test_blocks_cache_loads_across_packages(shard_problem, tmp_path):
    from repro.data.store import DatasetStore as JaxStore
    from repro.distributed.ingest import blocks_from_store as jax_from_store
    from repro_torch.data.store import DatasetStore
    from repro_torch.distributed.ingest import blocks_from_store
    X, host, y = shard_problem
    JaxStore.from_arrays(str(tmp_path / "j"), X, y, rows_per_shard=48)
    jax_written = jax_from_store(JaxStore.open(str(tmp_path / "j")), 2, 2)
    got = DatasetStore.open(str(tmp_path / "j")).blocks_load(2, 2)      # the port reads JAX's
    DatasetStore.from_arrays(str(tmp_path / "t"), host, y, rows_per_shard=48)
    port_written = blocks_from_store(DatasetStore.open(str(tmp_path / "t")), 2, 2)
    back = JaxStore.open(str(tmp_path / "t")).blocks_load(2, 2)          # JAX reads the port's
    assert got is not None and back is not None
    for part in ("csc_rows", "csc_vals", "csr_cols", "csr_vals"):
        np.testing.assert_array_equal(getattr(got, part).numpy(),
                                      np.asarray(getattr(jax_written, part)))
        np.testing.assert_array_equal(np.asarray(getattr(back, part)),
                                      getattr(port_written, part).numpy())
    assert tuple(back.padded) == port_written.padded


# ---------------------------------------------------------------------------
# the selection's helpers
# ---------------------------------------------------------------------------


def test_logsumexp_and_top_k_follow_jax():
    from repro_torch.distributed.fw_shard import logsumexp, top_k
    g = np.random.default_rng(0)
    x = g.standard_normal((3, 50)).astype(np.float32) * 20
    x[1, :40] = -np.inf
    x[2] = -np.inf
    got = logsumexp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6)
    assert got[2] == want[2] == -np.inf
    ties = np.zeros((2, 30), np.float32)                # ties among zeros: lower index first
    ties[0, [3, 17]] = 1.0
    ties[1, [29, 4, 11]] = [2.0, 2.0, 0.5]
    for k in (1, 4, 8):
        np.testing.assert_array_equal(top_k(torch.from_numpy(ties), k).numpy(),
                                      np.asarray(jax.lax.top_k(jnp.asarray(ties), k)[1]))


# ---------------------------------------------------------------------------
# registry wiring
# ---------------------------------------------------------------------------


def test_registry_has_jax_shard():
    from repro_torch.core.solvers.registry import UNPORTED_BACKENDS
    assert "jax_shard" in available_backends() and not UNPORTED_BACKENDS
    backend = get_backend("jax_shard")
    assert backend.data_format == "blocks" and not backend.supports_max_seconds
    assert resolve_queue(backend, _cfg(queue="bsls")).queue == "gumbel"
    assert resolve_queue(backend, _cfg(queue="two_level")).queue == "gumbel"
    assert resolve_queue(backend, _cfg(queue="fib_heap")).queue == "argmax"
    assert resolve_queue(backend, _cfg(queue="group_argmax")).queue == "argmax"
    assert resolve_queue(backend, _cfg()).queue == "argmax"
    with pytest.raises(ValueError, match="does not support queue"):
        resolve_queue(backend, _cfg(queue="noisy_max"))


def test_mesh_must_fit_devices(shard_problem):
    _, host, y = shard_problem
    with pytest.raises(ValueError, match="devices"):
        solve(host, y, _cfg(steps=2, mesh=(64, 64)))
    with pytest.raises(ValueError, match="max_seconds"):
        solve(host, y, _cfg(steps=2, max_seconds=5.0))


def test_grid_treats_mesh_spec_as_scalar():
    cfgs = grid(backend="jax_shard", mesh=(1, 1), lam=(4.0, 8.0))
    assert len(cfgs) == 2 and all(c.mesh == (1, 1) for c in cfgs)
    swept = grid(backend="jax_shard", mesh=((1, 1), (2, 2)))
    assert [c.mesh for c in swept] == [(1, 1), (2, 2)]


# ---------------------------------------------------------------------------
# 1×1 parity
# ---------------------------------------------------------------------------


def test_nonprivate_parity_vs_host_sparse_and_jax(shard_problem):
    from repro.core.solvers import FWConfig as JaxConfig, solve as jax_solve
    X, host, y = shard_problem
    shard = solve(host, y, _cfg(lam=8.0, steps=60))
    ref = solve(host, y, FWConfig(backend="host_sparse", lam=8.0, steps=60, device="cpu"))
    jx = jax_solve(X, y, JaxConfig(backend="jax_shard", lam=8.0, steps=60))
    assert torch.equal(shard.coords, ref.coords)
    np.testing.assert_array_equal(shard.coords.numpy(), np.asarray(jx.coords))
    for want in (ref, jx):
        _close(shard.w, want.w)
        _close(shard.gaps, want.gaps)
    assert shard.stop_step == 60 and shard.stop_reason == "max_steps"


def test_private_parity_vs_reference_and_jax(shard_problem):
    from repro.core.solvers.jax_shard import shard_em_scale as jax_em_scale
    from repro.distributed.block_sparse import build_block_sparse as jax_blocks
    from repro.distributed.fw_shard import DistFWConfig as JaxDistConfig
    from repro.distributed.fw_shard import distributed_fw as jax_distributed_fw
    from repro_torch.core.solvers.jax_shard import shard_em_scale
    from repro_torch.distributed import build_block_sparse
    from repro_torch.distributed.reference import reference_fw
    X, host, y = shard_problem
    n, d = X.shape
    cfg = resolve_queue(get_backend("jax_shard"), _cfg(lam=8.0, steps=40, queue="bsls",
                                                       epsilon=1.0, delta=1e-6, seed=3))
    res = solve(host, y, cfg)
    blocks = build_block_sparse(host, 1, 1)
    w_ref, gaps_ref, coords_ref = reference_fw(blocks, _y_pad(y, blocks.padded[0]), lam=8.0,
                                               steps=40, selection="gumbel",
                                               em_scale=shard_em_scale(cfg, n), seed=3,
                                               device="cpu")
    assert shard_em_scale(cfg, n) == jax_em_scale(cfg, n)
    jb = jax_blocks(X, 1, 1)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        jw, jg, jc, _ = jax_distributed_fw(
            jb, jnp.asarray(_y_pad(y, jb.padded[0])),
            JaxDistConfig(lam=8.0, steps=40, selection="gumbel", epsilon=1.0, delta=1e-6,
                          seed=3), mesh)
    assert torch.equal(res.coords, coords_ref)
    np.testing.assert_array_equal(res.coords.numpy(), np.asarray(jc))
    for w, g in ((w_ref, gaps_ref), (np.asarray(jw), np.asarray(jg))):
        _close(res.w, np.asarray(w)[:d])
        _close(res.gaps, g)
    assert len(set(res.coords.tolist())) > 5          # the mechanism explores


@pytest.mark.parametrize("loss", LOSSES)
def test_shard_parity_per_loss(shard_problem, loss):
    from repro.core.solvers import FWConfig as JaxConfig, solve as jax_solve
    from repro.distributed.block_sparse import build_block_sparse as jax_blocks
    from repro.distributed.reference import reference_fw as jax_reference_fw
    from repro_torch.core.solvers.jax_shard import shard_em_scale
    from repro_torch.distributed import build_block_sparse
    from repro_torch.distributed.reference import reference_fw
    X, host, y = shard_problem
    n, d = X.shape
    shard = solve(host, y, _cfg(lam=8.0, steps=30, loss=loss))
    ref = solve(host, y, FWConfig(backend="host_sparse", lam=8.0, steps=30, loss=loss,
                                  device="cpu"))
    jx = jax_solve(X, y, JaxConfig(backend="jax_shard", lam=8.0, steps=30, loss=loss))
    assert torch.equal(shard.coords, ref.coords), loss
    np.testing.assert_array_equal(shard.coords.numpy(), np.asarray(jx.coords), err_msg=loss)
    _close(shard.w, ref.w)
    _close(shard.w, jx.w)
    cfg = resolve_queue(get_backend("jax_shard"),
                        _cfg(lam=8.0, steps=30, loss=loss, queue="bsls", epsilon=1.0,
                             delta=1e-6, seed=3))
    res = solve(host, y, cfg)
    em = shard_em_scale(cfg, n)
    blocks = build_block_sparse(host, 1, 1)
    w_ref, _, coords_ref = reference_fw(blocks, _y_pad(y, blocks.padded[0]), lam=8.0, steps=30,
                                        selection="gumbel", em_scale=em, seed=3, loss=loss,
                                        device="cpu")
    jb = jax_blocks(X, 1, 1)
    jw, _, jc = jax_reference_fw(jb, jnp.asarray(_y_pad(y, jb.padded[0])), lam=8.0, steps=30,
                                 selection="gumbel", em_scale=em, seed=3, loss=loss)
    assert torch.equal(res.coords, coords_ref), loss
    np.testing.assert_array_equal(res.coords.numpy(), np.asarray(jc), err_msg=loss)
    _close(res.w, w_ref[:d])
    _close(res.w, np.asarray(jw)[:d])


def test_gap_tol_masks_the_tail(shard_problem):
    from repro.core.solvers import FWConfig as JaxConfig, solve as jax_solve
    X, host, y = shard_problem
    full = solve(host, y, _cfg(lam=8.0, steps=60))
    stop = solve(host, y, _cfg(lam=8.0, steps=60, gap_tol=3e-3))
    jx = jax_solve(X, y, JaxConfig(backend="jax_shard", lam=8.0, steps=60, gap_tol=3e-3))
    assert stop.stop_reason == "gap_tol" and 0 < stop.stop_step < 60
    assert stop.stop_step == jx.stop_step
    k = stop.stop_step
    assert torch.equal(stop.coords[:k], full.coords[:k]) and (stop.coords[k:] == -1).all()
    assert (stop.gaps[k:] == 0).all()
    np.testing.assert_array_equal(stop.coords.numpy(), np.asarray(jx.coords))
    _close(stop.w, jx.w)


# ---------------------------------------------------------------------------
# sweeps, stores, the service, the accountant
# ---------------------------------------------------------------------------


def test_solve_many_grid_lanes_equal_own_solves(shard_problem):
    from repro.core.solvers import FWConfig as JaxConfig, grid as jax_grid
    from repro.core.solvers import solve_many as jax_solve_many
    X, host, y = shard_problem
    configs = grid(_cfg(steps=25, queue="bsls", delta=1e-6), lam=(4.0, 8.0),
                   epsilon=(0.5, 2.0), seed=(0, 1))
    assert len(configs) == 8
    batched = solve_many(host, y, configs)
    jx = jax_solve_many(X, y, jax_grid(JaxConfig(backend="jax_shard", steps=25, queue="bsls",
                                                 delta=1e-6),
                                       lam=(4.0, 8.0), epsilon=(0.5, 2.0), seed=(0, 1)))
    for cfg, b, j in zip(configs, batched, jx):
        own = solve(host, y, cfg)
        for name in ("w", "gaps", "coords"):                  # lanes: each config's own bits
            assert torch.equal(getattr(b, name), getattr(own, name)), name
        np.testing.assert_array_equal(b.coords.numpy(), np.asarray(j.coords))
        _close(b.w, j.w)


def test_solve_from_dataset_ref_with_block_cache(shard_problem, tmp_path):
    from repro_torch.data.store import DatasetRef, DatasetStore
    _, host, y = shard_problem
    root = str(tmp_path / "store")
    DatasetStore.from_arrays(root, host, y, rows_per_shard=48)          # 3 shards
    cfg = _cfg(lam=8.0, steps=30)
    mem = solve(host, y, cfg)
    ref = solve(DatasetRef(path=root), config=cfg)                      # labels from the store
    for name in ("w", "gaps", "coords"):
        assert torch.equal(getattr(ref, name), getattr(mem, name))
    assert os.path.exists(os.path.join(root, "cache", "blocks-1x1-meta.json"))
    store = DatasetStore.open(root)
    cached = store.blocks_load(1, 1)
    assert cached is not None and cached.shape == host.shape
    assert torch.equal(solve(store, config=cfg).coords, mem.coords)


def test_fit_service_from_store_on_jax_shard(shard_problem, tmp_path):
    from repro_torch.core.dp.accountant import PrivacyAccountant
    from repro_torch.data.store import DatasetStore
    from repro_torch.serve import FitRequest, FitService, FitServiceConfig
    _, host, y = shard_problem
    store = DatasetStore.from_arrays(str(tmp_path / "store"), host, y)
    svc = FitService(store, accountants={
        "acme": PrivacyAccountant(epsilon=4.0, delta=1e-6, total_steps=4000)},
        config=FitServiceConfig(device="cpu"))
    private = dict(lam=8.0, steps=20, queue="bsls", epsilon=1.0, delta=1e-6, device="cpu")
    reqs = [FitRequest(0, "acme", FWConfig(backend="jax_shard", **private)),
            FitRequest(1, "acme", FWConfig(backend="jax_sparse", **private)),
            FitRequest(2, "acme", _cfg(lam=8.0, steps=20)),
            FitRequest(3, "noone", FWConfig(backend="jax_shard", **private))]
    for r in reqs:
        svc.submit(r)
    by_uid = {r.uid: r for r in svc.run()}
    assert [by_uid[i].status for i in range(4)] == ["done", "done", "done", "rejected"]
    acct = svc.accountants["acme"]
    assert acct.spent_steps == 2 * svc._charged_steps(acct, by_uid[0].config)
    direct = solve(store, config=by_uid[2].config)
    assert torch.equal(by_uid[2].result.coords, direct.coords)
    assert torch.equal(by_uid[0].result.coords, solve(store, config=by_uid[0].config).coords)


def test_em_scale_semantics_pinned():
    from repro_torch.core.dp.accountant import em_log_weight_scale, per_step_epsilon
    from repro_torch.core.losses import get_loss
    from repro_torch.core.solvers.jax_shard import shard_em_scale
    from repro_torch.core.solvers.torch_sparse import em_scale_for
    from repro_torch.distributed import DistFWConfig
    n, eps, delta, steps = 2048, 0.7, 1e-6, 500
    lip = get_loss("logistic").lipschitz
    expected = per_step_epsilon(eps, delta, steps) * n / (2.0 * lip)
    assert expected == pytest.approx(
        eps / math.sqrt(8.0 * steps * math.log(1.0 / delta)) * n / (2 * lip))
    assert em_log_weight_scale(epsilon=eps, delta=delta, steps=steps, n_rows=n,
                               lipschitz=lip) == expected
    sparse_cfg = resolve_queue(get_backend("jax_sparse"),
                               FWConfig(backend="jax_sparse", queue="bsls", epsilon=eps,
                                        delta=delta, steps=steps))
    assert em_scale_for(sparse_cfg, n) == expected
    shard_cfg = resolve_queue(get_backend("jax_shard"),
                              FWConfig(backend="jax_shard", queue="bsls", epsilon=eps,
                                       delta=delta, steps=steps))
    assert shard_em_scale(shard_cfg, n) == expected
    assert DistFWConfig(epsilon=eps, delta=delta, steps=steps).em_scale(n) == expected
    assert em_scale_for(dataclasses.replace(sparse_cfg, queue="group_argmax"), n) == 1.0
    assert shard_em_scale(dataclasses.replace(shard_cfg, queue="argmax"), n) == 1.0


def test_world_size_one_group_goes_through_torch_distributed(shard_problem, tmp_path):
    """Under a process group of one rank the collectives run through
    ``torch.distributed`` and give the bits of the group-less run."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import LOCAL, make_mesh
    _, host, y = shard_problem
    assert make_mesh(1, 1) is LOCAL and not LOCAL.distributed
    alone = [solve(host, y, _cfg(lam=8.0, steps=30, queue=q)) for q in ("argmax", "bsls")]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(1, 1)
        assert mesh.distributed and mesh.backend == "gloo"
        x = torch.arange(4.0)
        assert torch.equal(mesh.psum(x, ("rows", "model")), x)
        assert torch.equal(mesh.all_gather(x, "model"), x[None])
        grouped = [solve(host, y, _cfg(lam=8.0, steps=30, queue=q)) for q in ("argmax", "bsls")]
        with pytest.raises(ValueError, match="devices"):
            make_mesh(2, 1)
    finally:
        dist.destroy_process_group()
    for a, g in zip(alone, grouped):
        for name in ("w", "gaps", "coords"):
            assert torch.equal(getattr(a, name), getattr(g, name)), name


def test_distributed_entry_points_default_to_the_card():
    """``distributed_fw`` and the 1×1 oracle run on the card unless the
    caller asks for the CPU; without a card they raise, never fall back."""
    import inspect
    from repro_torch.distributed import DistFWConfig, build_block_sparse, distributed_fw
    from repro_torch.distributed.reference import reference_fw
    for fn in (distributed_fw, reference_fw):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        return
    X = HostCSR(np.array([0, 1, 2]), np.array([0, 1]), np.array([1.0, -1.0]), (2, 2))
    blocks = build_block_sparse(X, 1, 1)
    y_pad = np.zeros(blocks.padded[0], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_fw(blocks, y_pad, DistFWConfig(lam=1.0, steps=2, selection="argmax"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reference_fw(blocks, y_pad, lam=1.0, steps=2, selection="argmax")


def test_new_modules_import_without_jax():
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.distributed, repro_torch.distributed.reference\n"
            "import repro_torch.core.solvers.jax_shard, repro_torch.launch.shard\n"
            "import repro_torch.kernels.scatter\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
