"""The port's ``host_sparse`` engine — its copies of ``fw_sparse`` and the host
queues — against the JAX package's.

* ``sparse_fw`` equals JAX's array for array (w, gaps, coords) and in its
  audit (``flops``, ``queue_work``, ``pops``, stop step and reason), for
  each queue (``fib_heap``, ``argmax``, ``noisy_max``, ``bsls``), both paths
  (``fast`` and per-row) and the five losses.
* ``gap_tol`` stops at JAX's step with JAX's sentinels; ``max_seconds``
  stops the loop.
* The host queues pop for pop against JAX's over the same updates.
* ``solve(backend="host_sparse")`` returns JAX's result as float32/int32
  tensors on the requested device.
"""
import numpy as np
import pytest
import torch

from repro.core.fw_sparse import sparse_fw as jax_sparse_fw
from repro.core.samplers import base as jbase
from repro.core.samplers.bsls import BSLSSampler as JaxBSLS
from repro.core.samplers.fib_heap import FibHeapQueue as JaxFib
from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.fw_sparse import sparse_fw, sparse_fw_flops_estimate
from repro_torch.core.samplers import base as tbase
from repro_torch.core.samplers.bsls import BSLSSampler
from repro_torch.core.samplers.fib_heap import FibHeapQueue
from repro_torch.core.sparse.formats import HostCSR

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
QUEUES = ["fib_heap", "argmax", "noisy_max", "bsls"]


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=120, d=400, nnz_per_row=9, informative=12, seed=3)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _same(got, want):
    for name in ("w", "gaps", "coords"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("flops", "queue_work", "pops", "stop_step", "stop_reason"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("queue", QUEUES)
@pytest.mark.parametrize("loss", LOSSES)
def test_sparse_fw_equals_jax(problem, loss, queue, fast):
    X, host, y = problem
    kw = dict(lam=6.0, steps=25, loss=loss, queue=queue, epsilon=1.0, delta=1e-6, seed=4,
              fast=fast)
    _same(sparse_fw(host, y, **kw), jax_sparse_fw(X, y, **kw))


@pytest.mark.parametrize("queue", ["fib_heap", "bsls"])
def test_gap_tol_stop_and_sentinels_equal_jax(problem, queue):
    X, host, y = problem
    full = jax_sparse_fw(X, y, lam=6.0, steps=60, queue=queue)
    tol = float(np.float32(abs(full.gaps[20])))   # step 21 meets it: the run stops early
    kw = dict(lam=6.0, steps=60, queue=queue, gap_tol=tol)
    got, want = sparse_fw(host, y, **kw), jax_sparse_fw(X, y, **kw)
    _same(got, want)
    assert got.stop_reason == "gap_tol" and got.stop_step < 60
    assert (got.coords[got.stop_step:] == -1).all() and (got.gaps[got.stop_step:] == 0).all()


def test_max_seconds_stops(problem):
    _, host, y = problem
    res = sparse_fw(host, y, lam=6.0, steps=500, max_seconds=0.0)
    assert res.stop_reason == "max_seconds" and res.stop_step == 1
    assert (res.coords[1:] == -1).all()


def test_flops_estimate_equals_jax():
    from repro.core.fw_sparse import sparse_fw_flops_estimate as jax_estimate
    args = (20242, 47236, 1497342, 500, 74.0, 31.7, 120)
    assert sparse_fw_flops_estimate(*args) == jax_estimate(*args)


def _updates(d, rounds, seed):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        idx = np.unique(rng.integers(0, d, size=12))
        yield idx, np.abs(rng.normal(0, 2, size=idx.size))


def test_fib_heap_queue_pops_like_jax():
    d = 300
    mag = np.abs(np.random.default_rng(0).normal(size=d))
    live = mag.copy()
    ours, theirs = (cls(d, magnitude=lambda j: abs(live[j])) for cls in (FibHeapQueue, JaxFib))
    for q in (ours, theirs):
        q.add_all(mag)
    for idx, vals in _updates(d, 40, 1):
        live[idx] = vals
        ours.update_batch(idx, vals)
        theirs.update_batch(idx, vals)
        assert ours.get_next() == theirs.get_next()
        assert (ours.pops, ours.work, ours.calls) == (theirs.pops, theirs.work, theirs.calls)


@pytest.mark.parametrize("fast", [True, False])
def test_bsls_sampler_draws_like_jax(fast):
    d = 257
    lw = np.random.default_rng(2).normal(0, 2, size=d)
    ours, theirs = BSLSSampler(lw, seed=5), JaxBSLS(lw, seed=5)
    for idx, vals in _updates(d, 30, 3):
        for s in (ours, theirs):
            s.update_batch(idx, np.log(vals)) if fast else [s.update(int(i), float(np.log(v)))
                                                             for i, v in zip(idx, vals)]
        draw = (lambda s: s.sample_fast()) if fast else (lambda s: s.sample())
        assert draw(ours) == draw(theirs)
        np.testing.assert_array_equal(ours.c, theirs.c)
    assert (ours.rebuilds, ours.items_scanned, ours.groups_stepped) == \
        (theirs.rebuilds, theirs.items_scanned, theirs.groups_stepped)


@pytest.mark.parametrize("cls", ["ExactArgmaxQueue", "NoisyMaxQueue"])
def test_dense_queues_pop_like_jax(cls):
    d = 200
    mk = (lambda m: getattr(m, cls)(d)) if cls == "ExactArgmaxQueue" else \
        (lambda m: getattr(m, cls)(d, noise_scale=0.3, seed=9))
    ours, theirs = mk(tbase), mk(jbase)
    prio = np.abs(np.random.default_rng(4).normal(size=d))
    ours.add_all(prio)
    theirs.add_all(prio)
    for idx, vals in _updates(d, 30, 5):
        ours.update_batch(idx, vals)
        theirs.update_batch(idx, vals)
        assert ours.get_next() == theirs.get_next()
    assert ours.work == theirs.work


@pytest.mark.parametrize("queue", ["fib_heap", "bsls"])
def test_solve_host_sparse_equals_jax(problem, queue):
    X, host, y = problem
    cfg = dict(lam=6.0, steps=30, queue=queue, epsilon=1.0, delta=1e-6, seed=2)
    got = solve(host, y, FWConfig(backend="host_sparse", device="cpu", **cfg))
    want = jax_solve(X, y, JaxConfig(backend="host_sparse", **cfg))
    assert got.w.dtype == torch.float32 and got.coords.dtype == torch.int32
    assert got.w.device.type == "cpu" and got.losses.abs().sum() == 0
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.gaps.numpy(), np.asarray(want.gaps))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    assert (got.stop_step, got.stop_reason) == (want.stop_step, want.stop_reason)
