"""The port's warm-started λ-paths (``solve_path``) against the JAX package's.

* ``path_plan`` (budgets, offsets, the ε split) and ``check_path_config``
  (its five refusals) give JAX's answers.
* Segment 0 of a path equals ``solve(segment_config(cfg, plan, 0))`` bit for
  bit (``torch_sparse`` private and not, ``dense``).
* Every segment takes JAX's path coordinates with its stop step and reason,
  also on a ``gap_tol`` path whose segments stop early.
* ``solve(..., lambdas=...)`` is ``solve_path``; ``solve_many`` of a path
  group gives the same bits under ``plan="vmap"`` (lanes) and
  ``"sequential"``, and keeps the input order beside plain configs.
* A separable ``torch_sparse`` path runs ``ell_rmatvec`` twice in all.

Tolerance: the cross-engine contract — coordinates exactly equal, w and the
gaps within atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve_path as jax_solve_path
from repro.core.solvers import path as jpath
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, obs, solve, solve_many
from repro_torch.core.solvers import PathResult, solve_path
from repro_torch.core.solvers import path as tpath
from repro_torch.core.solvers import torch_sparse
from repro_torch.core.sparse.formats import HostCSR

LAMBDAS = (40.0, 25.0, 15.0)
BASE = dict(lam=LAMBDAS[0], steps=48, chunk_steps=16, seed=5, lambdas=LAMBDAS)
RUNS = {"alg2_nonprivate": ("torch_sparse", "jax_sparse", dict(queue="group_argmax")),
        "alg2_private": ("torch_sparse", "jax_sparse",
                         dict(queue="two_level", epsilon=6.0, delta=1e-6)),
        "alg1_argmax": ("dense", "dense", dict()),
        "alg1_gumbel": ("dense", "dense", dict(selection="gumbel", epsilon=6.0, delta=1e-6))}


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _bits(got, ref, msg):
    for k in ("coords", "w", "gaps", "losses"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), f"{msg}: {k}"
    assert got.stop_step_or() == ref.stop_step_or(), msg
    assert got.stop_reason == ref.stop_reason, msg


# ---------------------------------------------------------------------------
# the plan and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(steps=48, epsilon=6.0), dict(steps=500, epsilon=1.0),
                                dict(steps=12, epsilon=0.5), dict(steps=4, epsilon=2.0)])
@pytest.mark.parametrize("lambdas", [LAMBDAS, (50.0, 30.0, 20.0, 10.0), (7.0,)])
@pytest.mark.parametrize("private", [True, False])
def test_path_plan_equals_jax(kw, lambdas, private):
    kw = dict(kw, delta=1e-6, chunk_steps=16, lambdas=lambdas)
    got = tpath.path_plan(FWConfig(**kw), private=private)
    want = jpath.path_plan(JaxConfig(**kw), private=private)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for k in range(len(lambdas)):
        a = tpath.segment_config(FWConfig(**kw), got, k)
        b = jpath.segment_config(JaxConfig(**kw), want, k)
        assert (a.lam, a.steps, a.epsilon, a.lambdas) == (b.lam, b.steps, b.epsilon, b.lambdas)
    for queue in ("two_level", "group_argmax"):
        assert tpath.path_em_scale(FWConfig(queue=queue, **kw), got, 150) == \
            jpath.path_em_scale(JaxConfig(queue=queue, **kw), want, 150)


@pytest.mark.parametrize("kw", [dict(lambdas=()), dict(lambdas=(30.0, -2.0)),
                                dict(lambdas=(20.0, 30.0)), dict(lambdas=(30.0, 30.0)),
                                dict(lambdas=LAMBDAS, screen_every=2),
                                dict(lambdas=LAMBDAS, max_seconds=1.0)])
def test_check_path_config_refuses_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jpath.check_path_config(JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        tpath.check_path_config(FWConfig(**kw))
    assert str(got.value) == str(want.value)
    tpath.check_path_config(FWConfig(lambdas=LAMBDAS))


def test_solve_path_refusals(problem):
    _, host, y = problem
    with pytest.raises(ValueError, match="lambdas"):
        solve_path(host, y, config=FWConfig(steps=8, device="cpu"))
    # a mesh names the sharded engine's grid only: a dense path reads none,
    # and the sharded engine solves no λ-paths (as in the JAX package)
    meshed = solve_path(host, y, config=FWConfig(steps=8, device="cpu", lambdas=LAMBDAS,
                                                 mesh=(2, 2)))
    plain = solve_path(host, y, config=FWConfig(steps=8, device="cpu", lambdas=LAMBDAS))
    assert all(torch.equal(a.coords, b.coords) and torch.equal(a.w, b.w)
               for a, b in zip(meshed.results, plain.results))
    with pytest.raises(ValueError, match="path"):
        solve_path(host, y, config=FWConfig(backend="jax_shard", steps=8, device="cpu",
                                            lambdas=LAMBDAS))
    with pytest.raises(ValueError, match="decreasing"):
        solve(host, y, FWConfig(steps=8, device="cpu", lambdas=(1.0, 2.0)))


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(RUNS))
def test_segment0_is_the_standalone_solve(problem, run):
    _, host, y = problem
    backend, _, rule = RUNS[run]
    cfg = FWConfig(backend=backend, device="cpu", **BASE, **rule)
    with obs.session() as tel:
        path = solve_path(host, y, config=cfg)
    assert isinstance(path, PathResult) and len(path) == len(LAMBDAS)
    assert path.final is path[2]
    _bits(path[0], solve(host, y, tpath.segment_config(cfg, path.plan, 0)), run)
    events = [e["attrs"] for e in tel.events if e["name"] == "path.lambda"]
    assert [e["lam"] for e in events] == list(LAMBDAS)
    assert [e["budget"] for e in events] == list(path.plan.budgets)
    assert [e["offset"] for e in events] == list(path.plan.offsets)
    assert any(e["name"] == "solve_path" for e in tel.events if e["ev"] == "span")
    for lam_k, res in zip(LAMBDAS, path):
        assert torch.isfinite(res.w).all()
        assert float(res.w.abs().sum()) <= LAMBDAS[0] * (1 + 1e-5)


def _tol_mid_segment0(gaps: np.ndarray) -> float:
    """A tolerance midway between two distinct positive gaps of segment 0's
    fixed trace (at least 2e-6 apart, so a last-ulp difference cannot move
    the stop), whose first crossing lies nearest the segment's middle; the
    warm segments, whose gaps start low, then stop early too."""
    pos = np.unique(gaps[gaps > 0]).astype(np.float64)
    cands = [0.5 * (a + b) for a, b in zip(pos[:-1], pos[1:]) if b - a > 2e-6]
    first = lambda tol: int(np.argmax(gaps <= np.float32(tol)))
    return min(cands, key=lambda tol: abs(first(tol) - len(gaps) // 2))


@pytest.mark.parametrize("gap_tol", [False, True])
@pytest.mark.parametrize("run", list(RUNS))
def test_path_takes_jax_coordinates(problem, run, gap_tol):
    X, host, y = problem
    backend, jax_backend, rule = RUNS[run]
    kw = dict(BASE, **rule)
    if gap_tol:
        full = jax_solve_path(X, y, config=JaxConfig(backend=jax_backend, **kw))
        kw["gap_tol"] = _tol_mid_segment0(np.asarray(full[0].gaps))
    with jobs.session() as jtel:
        ref = jax_solve_path(X, y, config=JaxConfig(backend=jax_backend, **kw))
    got = solve_path(host, y, config=FWConfig(backend=backend, device="cpu", **kw))
    stops = []
    for k, (g, r) in enumerate(zip(got, ref)):
        msg = f"{run} gap_tol={gap_tol} segment {k}"
        np.testing.assert_array_equal(g.coords.numpy(), np.asarray(r.coords), err_msg=msg)
        np.testing.assert_allclose(g.w.numpy(), np.asarray(r.w), rtol=0, atol=1e-4,
                                   err_msg=msg)
        np.testing.assert_allclose(g.gaps.numpy(), np.asarray(r.gaps), rtol=0, atol=1e-4,
                                   err_msg=msg)
        assert (g.stop_step_or(), g.stop_reason) == (r.stop_step_or(), r.stop_reason), msg
        stops.append(g.stop_step_or())
    if gap_tol:
        assert any(s < b for s, b in zip(stops, got.plan.budgets)), stops
    jev = [e["attrs"]["stop_step"] for e in jtel.events if e["name"] == "path.lambda"]
    assert jev == stops


def test_solve_delegates_path_configs(problem):
    _, host, y = problem
    cfg = FWConfig(backend="torch_sparse", device="cpu", queue="group_argmax", **BASE)
    via_solve = solve(host, y, cfg)
    assert isinstance(via_solve, PathResult)
    for a, b in zip(via_solve, solve_path(host, y, config=cfg)):
        _bits(a, b, "solve vs solve_path")


def test_separable_path_runs_two_setup_sweeps(problem, monkeypatch):
    _, host, y = problem
    calls = []
    real = torch_sparse.ell_rmatvec

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_sparse, "ell_rmatvec", counting)
    for queue in ("two_level", "group_argmax"):
        calls.clear()
        solve_path(host, y, config=FWConfig(backend="torch_sparse", device="cpu", queue=queue,
                                            epsilon=6.0, **BASE))
        assert len(calls) == 2, queue


# ---------------------------------------------------------------------------
# solve_many: path groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
@pytest.mark.parametrize("gap_tol", [0.0, 0.02])
def test_solve_many_path_group_lanes_equal_sequential(problem, queue, gap_tol):
    _, host, y = problem
    cfgs = [FWConfig(backend="torch_sparse", device="cpu", queue=queue, epsilon=eps,
                     delta=1e-6, gap_tol=gap_tol, **{**BASE, "seed": seed})
            for eps, seed in ((4.0, 0), (8.0, 1), (6.0, 2))]
    with obs.session() as tel:
        lanes = solve_many(host, y, cfgs, plan="vmap")
    modes = [e["attrs"]["mode"] for e in tel.events
             if e["ev"] == "span" and e["name"] == "group.path"]
    assert modes == ["fused"]
    seq = solve_many(host, y, cfgs, plan="sequential")
    for i, (a, b, c) in enumerate(zip(lanes, seq, cfgs)):
        assert isinstance(a, PathResult) and a.plan == b.plan
        own = solve_path(host, y, config=c)
        for k in range(len(LAMBDAS)):
            _bits(a[k], b[k], f"config {i} segment {k} lanes vs sequential")
            _bits(a[k], own[k], f"config {i} segment {k} lanes vs own path")


def test_solve_many_mixes_paths_and_plain_solves(problem):
    _, host, y = problem
    path_cfg = FWConfig(backend="torch_sparse", device="cpu", queue="group_argmax", **BASE)
    plain = FWConfig(backend="torch_sparse", device="cpu", queue="group_argmax", lam=25.0,
                     steps=32, chunk_steps=16, seed=5)
    dense_path = FWConfig(backend="dense", device="cpu", **BASE)
    out = solve_many(host, y, [plain, path_cfg, dense_path, plain])
    assert [isinstance(r, PathResult) for r in out] == [False, True, True, False]
    _bits(out[0], solve(host, y, plain), "plain")
    _bits(out[3], solve(host, y, plain), "plain again")
    for a, b in zip(out[1], solve_path(host, y, config=path_cfg)):
        _bits(a, b, "path")
    for a, b in zip(out[2], solve_path(host, y, config=dense_path)):
        _bits(a, b, "dense path")
