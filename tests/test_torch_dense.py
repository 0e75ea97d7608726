"""The port's Alg 1 (``backend="dense"``) against the JAX package's.

``repro_torch`` ``solve`` with ``device="cpu"`` (the spmv kernels' plain
versions on a padded pair, ``torch.matmul`` on a dense matrix) against
``repro`` ``solve`` with ``backend="dense"``, on the same numpy inputs: every
loss × every selection rule × {padded pair, dense matrix}.

Tolerance: the repo's cross-engine contract (tests/test_solvers.py) —
coordinates exactly equal; w, gaps and per-step losses within atol 1e-4.
The private rules draw from the same threefry key stream, so their
coordinates are held exactly too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.fw_dense import dense_fw_flops as j_dense_fw_flops
from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.core.sparse.formats import host_to_padded as j_host_to_padded
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.fw_dense import dense_fw_flops, dense_fw_screened
from repro_torch.core.solvers import get_backend
from repro_torch.core.sparse.formats import HostCSR, host_to_padded
from repro_torch.kernels import launch_counts

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
SELECTIONS = ["argmax", "noisy_max", "gumbel"]


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    host = HostCSR(X.indptr, X.indices, X.data, X.shape)
    return X, host, y


def assert_same_run(ref, got, msg):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords),
                                  err_msg=f"{msg}: coords")
    for name in ("w", "gaps", "losses"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("form", ["padded", "dense"])
@pytest.mark.parametrize("selection", SELECTIONS)
@pytest.mark.parametrize("loss", LOSSES)
def test_dense_matches_jax_dense(problem, loss, selection, form):
    X, host, y = problem
    kw = dict(lam=8.0, steps=30, loss=loss, selection=selection, epsilon=20.0, delta=1e-6)
    if form == "padded":
        jx, tx = j_host_to_padded(X), host_to_padded(host, device="cpu")
    else:
        jx, tx = X.to_dense(), X.to_dense()
    ref = jax_solve(jx, y, JaxConfig(backend="dense", **kw))
    before = launch_counts()
    got = solve(tx, y, FWConfig(backend="dense", device="cpu", **kw))
    assert launch_counts() == before                     # CPU: the plain versions
    assert got.w.device.type == "cpu" and got.coords.dtype == torch.int32
    assert got.stop_step == 30 and got.stop_reason == "max_steps"
    assert_same_run(ref, got, f"{loss} {selection} {form}")


def test_dense_takes_every_input_form_alike(problem):
    X, host, y = problem
    cfg = FWConfig(backend="dense", lam=8.0, steps=25, device="cpu")
    runs = [solve(x, y, cfg) for x in (host, host.to_dense(), torch.from_numpy(host.to_dense()),
                                       host_to_padded(host, device="cpu"))]
    for r in runs[1:]:
        assert torch.equal(r.coords, runs[0].coords)
        torch.testing.assert_close(r.w, runs[0].w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("queue,selection", [("two_level", "gumbel"), ("fib_heap", "argmax"),
                                             ("noisy_max", "noisy_max")])
def test_queue_names_select_the_alg1_rule(problem, queue, selection):
    _, host, y = problem
    base = FWConfig(backend="dense", lam=8.0, steps=20, device="cpu", epsilon=20.0)
    by_queue = solve(host, y, dataclasses.replace(base, queue=queue))
    by_rule = solve(host, y, dataclasses.replace(base, selection=selection))
    assert torch.equal(by_queue.coords, by_rule.coords) and torch.equal(by_queue.w, by_rule.w)


def test_default_backend_is_dense_and_jax_sparse_is_torch_sparse(problem):
    _, host, y = problem
    assert FWConfig().backend == JaxConfig().backend == "dense"
    assert get_backend("jax_sparse") is get_backend("torch_sparse")
    cfg = FWConfig(lam=8.0, steps=15, device="cpu")
    assert torch.equal(solve(host, y, cfg).coords,
                       solve(host, y, dataclasses.replace(cfg, backend="dense")).coords)
    a = solve(host, y, dataclasses.replace(cfg, backend="jax_sparse"))
    b = solve(host, y, dataclasses.replace(cfg, backend="torch_sparse"))
    assert torch.equal(a.coords, b.coords) and torch.equal(a.w, b.w)


def test_dense_refuses_what_it_does_not_do(problem):
    _, host, y = problem
    with pytest.raises(ValueError, match="selection"):
        solve(host, y, FWConfig(backend="dense", steps=5, device="cpu", selection="softmax"))
    with pytest.raises(ValueError, match="Screener requires screen_every > 0"):
        dense_fw_screened(host.to_dense(), torch.from_numpy(y), FWConfig(screen_every=0))
    # the JAX package's refusals of a screened config, before any compute
    for bad, match in ((dict(screen_every=-1), "screen_every"),
                       (dict(screen_every=2, screen_eps_frac=1.5), "screen_eps_frac"),
                       (dict(screen_every=2, screen_eps_frac=0.0), "screen_eps_frac"),
                       (dict(screen_every=2, lambdas=(8.0, 4.0)), "screen")):
        with pytest.raises(ValueError, match=match):
            solve(host, y, FWConfig(backend="dense", steps=5, device="cpu", **bad))
    with pytest.raises(TypeError):
        solve([[1.0]], y, FWConfig(backend="dense", steps=5, device="cpu"))


@pytest.mark.parametrize("n,d,nnz,steps", [(150, 600, 1500, 30), (20242, 47236, 1497342, 4000)])
def test_dense_fw_flops_equal(n, d, nnz, steps):
    assert dense_fw_flops(n, d, nnz, steps) == j_dense_fw_flops(n, d, nnz, steps)
