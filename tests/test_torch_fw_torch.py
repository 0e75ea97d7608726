"""The port's ``torch_dense`` engine (``core/fw_torch.py``) against the JAX
package's ``jax_dense`` (``core/fw_jax.py``), on the CPU.

* ``sparse_fw_torch`` takes ``sparse_fw_jax``'s coordinates, private and
  non-private, for the five losses and both tiles (JAX's full padded tile
  and the column's live rows); w and gaps within atol 1e-4 (the North-star
  contract between independently rounded engines).
* The masked ``gap_tol`` run stops at JAX's step, with (0.0, -1) past it.
* ``solve(backend="jax_dense")`` runs ``torch_dense``; ``max_seconds`` and
  a tiered column layout are refused before any compute.
* The tile a run walks by default (full for a private run on the card, the
  live rows otherwise) gives the forced tiles' coordinates and w bit for
  bit; the gaps differ only in the blocking of g̃'s float32 sum.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fw_jax import SparseJaxConfig, sparse_fw_jax_jit
from repro.core.sparse.formats import host_to_padded as jax_host_to_padded
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, obs, solve
from repro_torch.core.fw_torch import (SparseTorchConfig, default_tile, scatter_add,
                                       sparse_fw_torch)
from repro_torch.core.sparse.formats import HostCSR, host_to_padded, tiered_from_padded

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
ATOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=200, d=800, nnz_per_row=12, informative=20, seed=13)
    host = HostCSR(X.indptr, X.indices, X.data, X.shape)
    return jax_host_to_padded(X), host_to_padded(host, "cpu"), host, y


def _agree(got, want):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=ATOL)
    np.testing.assert_allclose(got.gaps.numpy(), np.asarray(want.gaps), atol=ATOL)


@pytest.mark.parametrize("tile", ["full", "live"])
@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
@pytest.mark.parametrize("loss", LOSSES)
def test_sparse_fw_torch_takes_jax_coords(problem, loss, queue, tile):
    jpair, tpair, _, y = problem
    kw = dict(lam=8.0, steps=40, loss=loss, queue=queue, epsilon=1.0, delta=1e-6, seed=3)
    want = sparse_fw_jax_jit(*jpair, jnp.asarray(y, jnp.float32), SparseJaxConfig(**kw))
    got = sparse_fw_torch(*tpair, torch.from_numpy(y.astype(np.float32)),
                          SparseTorchConfig(device="cpu", **kw), tile=tile)
    _agree(got, want)
    assert int(got.stop_step) == 40


@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
def test_masked_gap_tol_stops_at_jax_step(problem, queue):
    jpair, tpair, _, y = problem
    kw = dict(lam=8.0, steps=60, queue=queue, seed=1)
    full = sparse_fw_jax_jit(*jpair, jnp.asarray(y, jnp.float32), SparseJaxConfig(**kw))
    tol = float(abs(np.asarray(full.gaps)[25]))        # step 26 meets it at the latest
    kw["gap_tol"] = tol
    want = sparse_fw_jax_jit(*jpair, jnp.asarray(y, jnp.float32), SparseJaxConfig(**kw))
    for tile in ("full", "live"):
        got = sparse_fw_torch(*tpair, torch.from_numpy(y.astype(np.float32)),
                              SparseTorchConfig(device="cpu", **kw), tile=tile)
        stop = int(got.stop_step)
        assert stop == int(want.stop_step) < 60
        _agree(got, want)
        assert (got.coords[stop:] == -1).all() and (got.gaps[stop:] == 0).all()
        assert float(got.gaps[stop - 1]) <= tol


def test_solve_jax_dense_runs_torch_dense(problem):
    _, tpair, host, y = problem
    cfg = FWConfig(backend="jax_dense", lam=8.0, steps=20, device="cpu")
    with obs.session() as tel:
        res = solve(host, y, cfg)
    spans = [e for e in tel.events if e["ev"] == "span" and e["name"] == "solve"]
    assert spans[-1]["attrs"]["backend"] == "torch_dense"
    assert spans[-1]["attrs"]["queue"] == "group_argmax"
    ref = solve(tpair, y, dataclasses.replace(cfg, backend="torch_dense"))
    assert torch.equal(res.w, ref.w) and torch.equal(res.coords, ref.coords)
    assert res.stop_step == 20 and res.stop_reason == "max_steps"
    stopped = solve(host, y, dataclasses.replace(cfg, steps=60, gap_tol=float(ref.gaps[5])))
    assert stopped.stop_reason == "gap_tol" and stopped.stop_step < 60


def test_torch_dense_refuses_max_seconds_and_tiered_pairs(problem):
    _, (pcsr, pcsc), host, y = problem
    with pytest.raises(ValueError, match="wall clock"):
        solve(host, y, FWConfig(backend="torch_dense", steps=5, max_seconds=1.0, device="cpu"))
    tiered = tiered_from_padded(pcsc, 2)
    with pytest.raises(ValueError, match="flat PaddedCSC"):
        solve((pcsr, tiered), y, FWConfig(backend="torch_dense", steps=5, device="cpu"))
    with pytest.raises(ValueError, match="tile"):
        sparse_fw_torch(pcsr, pcsc, torch.zeros(pcsr.shape[0]),
                        SparseTorchConfig(device="cpu", steps=2), tile="bogus")


def test_scatter_add_adds_in_input_order():
    """Live lanes add in input order; dead lanes add nothing anywhere."""
    dst = torch.tensor([1.0, 2.0, 3.0])
    idx = torch.tensor([0, 2, 0, 0, 1])
    src = torch.tensor([1e8, 5.0, 1.0, -1e8, 7.0])
    live = torch.tensor([True, True, True, True, False])
    out = scatter_add(dst, idx, src, live)
    want0 = np.float32(np.float32(np.float32(1.0) + np.float32(1e8)) + np.float32(1.0)) \
        + np.float32(-1e8)
    assert out.tolist() == [float(want0), 2.0, 8.0]
    assert dst.tolist() == [1.0, 2.0, 3.0]


@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
def test_default_tile_gives_the_forced_tiles_bits(problem, queue):
    _, tpair, _, y = problem
    cfg = SparseTorchConfig(lam=8.0, steps=30, queue=queue, device="cpu")
    private = queue == "two_level"
    assert default_tile(private, "cuda") == ("full" if private else "live")
    assert default_tile(private, "cpu") == "live"
    y_t = torch.from_numpy(y.astype(np.float32))
    got = sparse_fw_torch(*tpair, y_t, cfg)
    for tile in ("full", "live"):
        forced = sparse_fw_torch(*tpair, y_t, cfg, tile=tile)
        assert torch.equal(got.coords, forced.coords) and torch.equal(got.w, forced.w), tile
        # g̃'s sum runs over K_col or nnz[j] lanes: only the float32 sum's blocking differs
        torch.testing.assert_close(got.gaps, forced.gaps, rtol=0.0, atol=1e-7)
