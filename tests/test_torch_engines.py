"""The port's Alg 2 engines are one state machine, and the JAX package's.

* ``host_sparse``, ``torch_dense`` and ``torch_sparse`` take the same
  coordinates as each other and as JAX's ``host_sparse``, ``jax_dense`` and
  ``jax_sparse`` on the shared tiny problem (the port's counterpart of
  ``tests/test_solvers.py::test_alg2_backends_identical_on_sparse_problem``),
  non-private and — the device engines — private, for the five losses; w
  and gaps within atol 1e-4.
* The port's eager oracle ``reference_fw`` equals JAX's ``reference_fw``
  and the port's ``torch_sparse`` on the CPU (coordinates exactly, w and
  gaps within atol 1e-4), private and non-private, five losses.
* Both packages refuse screening and λ-paths on ``torch_dense``/``jax_dense``
  and ``host_sparse``; ``step_costs`` prices ``jax_dense`` as JAX does.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import planner as jplanner
from repro.core.solvers import registry as jregistry
from repro.core.solvers import solve as jax_solve
from repro.core.solvers.reference import reference_fw as jax_reference_fw
from repro.core.sparse.formats import host_to_padded as jax_host_to_padded
from repro_torch import FWConfig, solve
from repro_torch.core.solvers import planner, registry
from repro_torch.core.solvers.reference import reference_fw
from repro_torch.core.solvers.torch_sparse import em_scale_for
from repro_torch.core.sparse.formats import HostCSR, host_to_padded

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
ATOL = 1e-4
PORT_ENGINES = ("host_sparse", "torch_dense", "torch_sparse")
JAX_NAME = {"host_sparse": "host_sparse", "torch_dense": "jax_dense",
            "torch_sparse": "jax_sparse"}


@pytest.fixture(scope="module")
def tiny(tiny_problem):
    X, y, _ = tiny_problem
    host = HostCSR(X.indptr, X.indices, X.data, X.shape)
    return X, host, host_to_padded(host, "cpu"), y


def _agree(got, want, msg):
    np.testing.assert_array_equal(np.asarray(got.coords), np.asarray(want.coords), err_msg=msg)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w), atol=ATOL, err_msg=msg)
    np.testing.assert_allclose(np.asarray(got.gaps), np.asarray(want.gaps), atol=ATOL,
                               err_msg=msg)


def test_alg2_engines_identical_on_sparse_problem(tiny):
    X, host, pair, y = tiny
    cfg = dict(lam=8.0, steps=60)
    jax_runs = {b: jax_solve(X, y, JaxConfig(backend=b, **cfg)) for b in JAX_NAME.values()}
    ref = jax_runs["host_sparse"]
    for b in JAX_NAME.values():
        _agree(jax_runs[b], ref, f"JAX {b}")
    for b in PORT_ENGINES:
        got = solve(pair if b != "host_sparse" else host, y,
                    FWConfig(backend=b, device="cpu", **cfg))
        _agree(got, ref, b)
        _agree(got, jax_runs[JAX_NAME[b]], f"{b} against its JAX engine")
    assert float(ref.gaps[-1]) < float(ref.gaps[0]) / 4.0


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_engines_take_jax_coords(tiny, loss, private):
    X, host, pair, y = tiny
    cfg = dict(lam=8.0, steps=40, loss=loss, epsilon=1.0, delta=1e-6, seed=5,
               queue="two_level" if private else None)
    engines = ("torch_dense", "torch_sparse") if private else PORT_ENGINES
    runs = {b: solve(pair if b != "host_sparse" else host, y,
                     FWConfig(backend=b, device="cpu", **cfg)) for b in engines}
    want = jax_solve(X, y, JaxConfig(backend="jax_dense", **cfg))
    for b, got in runs.items():
        _agree(got, want, b)


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_reference_fw_equals_jax_and_torch_sparse(tiny, loss, private):
    X, host, pair, y = tiny
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=40, loss=loss, device="cpu",
                   queue="two_level" if private else "group_argmax", seed=2)
    em = em_scale_for(cfg, X.shape[0])
    kw = dict(lam=8.0, steps=40, private=private, em_scale=em, seed=2, loss=loss)
    w, gaps, coords = reference_fw(*pair, y, **kw)
    jw, jgaps, jcoords = jax_reference_fw(*jax_host_to_padded(X), y, **kw)
    got = dataclasses.make_dataclass("R", ["w", "gaps", "coords"])(w, gaps, coords)
    _agree(got, dataclasses.make_dataclass("R", ["w", "gaps", "coords"])(jw, jgaps, jcoords),
           "JAX reference_fw")
    _agree(got, solve(pair, y, cfg), "torch_sparse")


@pytest.mark.parametrize("backend", ["torch_dense", "host_sparse"])
def test_screening_and_paths_refused_in_both_packages(backend):
    port, jax_b = registry.get_backend(backend), jregistry.get_backend(JAX_NAME[backend])
    for b, check, mk in ((port, registry, FWConfig), (jax_b, jregistry, JaxConfig)):
        assert not b.supports_screening and not b.supports_path
        with pytest.raises(ValueError, match="screening"):
            check.check_screening_support(b, mk(screen_every=2))
        with pytest.raises(ValueError, match="λ-path"):
            check.check_path_support(b, mk(lambdas=(8.0, 4.0)))
    assert port.supports_max_seconds == jax_b.supports_max_seconds == (backend == "host_sparse")
    assert port.default_queue == jax_b.default_queue
    assert dict(port.queues) == dict(jax_b.queues)


def test_solve_refuses_screening_and_paths_before_compute(tiny):
    _, host, _, y = tiny
    for b in ("torch_dense", "host_sparse", "jax_dense"):
        with pytest.raises(ValueError, match="screening"):
            solve(host, y, FWConfig(backend=b, steps=5, screen_every=2, device="cpu"))
        with pytest.raises(ValueError, match="λ-path"):
            solve(host, y, FWConfig(backend=b, steps=5, lambdas=(8.0, 4.0), device="cpu"))


def test_step_costs_price_jax_dense_as_jax(tiny):
    X, host, _, _ = tiny
    stats, jstats = planner.data_stats(host), jplanner.data_stats(X)
    for name in ("jax_dense", "torch_dense"):
        assert planner.step_costs(stats, name) == jplanner.step_costs(jstats, "jax_dense")
    assert planner.step_costs(stats, "torch_sparse") == jplanner.step_costs(jstats, "jax_sparse")
    dense_term = np.subtract(planner.step_costs(stats, "torch_dense"),
                             planner.step_costs(stats, "torch_sparse"))
    assert tuple(dense_term) == (2.0 * stats.d, 8.0 * stats.d)
