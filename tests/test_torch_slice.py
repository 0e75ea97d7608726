"""The port's main path against the JAX package's: ``repro_torch`` ``solve``
with ``backend="torch_sparse", device="cpu"`` (the kernels' plain versions)
against ``repro`` ``solve`` with ``backend="jax_sparse"`` (Pallas in
interpret mode), on the flat padded layout, for every loss, private and
non-private.

Tolerance: the repo's cross-engine contract (tests/test_solvers.py) —
coordinates exactly equal, w and the gaps within atol 1e-4.
"""
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.sparse.formats import HostCSR
from repro_torch.data.synthetic import make_sparse_classification as torch_make

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]


@pytest.fixture(scope="module")
def sweep_problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return X, y


def assert_same_run(ref, got, msg):
    np.testing.assert_array_equal(got.coords.cpu().numpy(), np.asarray(ref.coords),
                                  err_msg=f"{msg}: coords")
    np.testing.assert_allclose(got.w.cpu().numpy(), np.asarray(ref.w), atol=1e-4,
                               err_msg=f"{msg}: w")
    np.testing.assert_allclose(got.gaps.cpu().numpy(), np.asarray(ref.gaps), atol=1e-4,
                               err_msg=f"{msg}: gaps")


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_torch_sparse_matches_jax_sparse(sweep_problem, loss, private):
    X, y = sweep_problem
    kw = dict(lam=8.0, steps=30, loss=loss, queue="bsls" if private else None,
              epsilon=1.0, delta=1e-6)
    ref = jax_solve(X, y, JaxConfig(backend="jax_sparse", **kw))
    got = solve(HostCSR(X.indptr, X.indices, X.data, X.shape), y,
                FWConfig(backend="torch_sparse", device="cpu", **kw))
    assert got.w.device.type == "cpu" and got.coords.dtype == torch.int32
    assert got.stop_step_or() == 30 and got.stop_reason == "max_steps"
    assert_same_run(ref, got, f"{loss} private={private}")


def test_torch_sparse_accepts_dense_and_padded_inputs(sweep_problem):
    from repro_torch.core.sparse.formats import host_to_padded
    X, y = sweep_problem
    host = HostCSR(X.indptr, X.indices, X.data, X.shape)
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=20, device="cpu", queue="two_level")
    a = solve(host, y, cfg)
    b = solve(host.to_dense(), y, cfg)
    c = solve(host_to_padded(host, device="cpu"), torch.from_numpy(y), cfg)
    for r in (b, c):
        assert torch.equal(a.coords, r.coords) and torch.equal(a.w, r.w)


def test_port_generator_equals_jax_generator():
    X, y, w = make_sparse_classification(n=120, d=500, nnz_per_row=9, informative=12, seed=5)
    Xt, yt, wt = torch_make(n=120, d=500, nnz_per_row=9, informative=12, seed=5)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(X, name), getattr(Xt, name))
    np.testing.assert_array_equal(y, yt)
    np.testing.assert_array_equal(w, wt)


def test_solve_refuses_missing_card_and_unported_backends(sweep_problem):
    X, y = sweep_problem
    host = HostCSR(X.indptr, X.indices, X.data, X.shape)
    shard = solve(host, y, FWConfig(backend="jax_shard", device="cpu", steps=5))   # A12
    assert torch.equal(shard.coords, solve(host, y, FWConfig(backend="host_sparse",
                                                             device="cpu", steps=5)).coords)
    for bad, match in ((dict(screen_every=-1), "screen_every"),
                       (dict(screen_every=2, screen_eps_frac=1.0), "screen_eps_frac"),
                       (dict(screen_every=2, screen_eps_frac=-0.2), "screen_eps_frac"),
                       (dict(screen_every=2, lambdas=(8.0, 4.0)), "screen")):
        with pytest.raises(ValueError, match=match):
            solve(host, y, FWConfig(backend="torch_sparse", device="cpu", steps=5, **bad))
    with pytest.raises(ValueError, match="queue"):
        solve(host, y, FWConfig(backend="torch_sparse", device="cpu", steps=5,
                                queue="noisy_max"))
    if torch.cuda.is_available():
        return   # the card is there: the default device is legitimately usable
    for backend in ("dense", "torch_sparse", "torch_dense", "host_sparse"):
        with pytest.raises(RuntimeError, match="CUDA"):   # default device is cuda: never a CPU run
            solve(host, y, FWConfig(backend=backend, steps=5))
