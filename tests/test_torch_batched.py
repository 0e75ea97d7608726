"""The port's ``solve_many``/``grid`` against its own ``solve`` and the JAX
package's ``solve_many`` (``solvers/batched.py``).

* ``grid`` gives JAX's config fields for scalar and sweep axes.
* ``solve_many`` equals sequential port ``solve`` runs bit for bit (w, gaps,
  coords, stop step and reason) under ``plan="vmap"`` (lanes) and
  ``plan="sequential"``: private and non-private groups, every loss, varied
  seeds, mixed backends (input order kept), empty and singleton grids, a
  store input, and ``gap_tol`` grids whose configs retire at their own stop
  steps.
* It takes the JAX package's ``solve_many`` coordinates exactly, with w and
  gaps within atol 1e-4 (the North-star contract); a tiered layout against
  JAX's flat one is held to the same, not to bits (ROADMAP.md §C).
* a mesh config runs (torch_sparse reads no mesh; a jax_shard mesh larger
  than the process group is refused); a screened group and a
  λ-path group run, each config equal to its own ``solve``; a bogus plan
  raises; a ``SolvePlan``'s chunk overrides the default.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import grid as jax_grid
from repro.core.solvers import solve_many as jax_solve_many
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, SolvePlan, grid, obs, solve, solve_many
from repro_torch.core.solvers import planner
from repro_torch.core.solvers.config import STOP_GAP_TOL, STOP_MAX_SECONDS
from repro_torch.core.sparse.formats import HostCSR, host_to_padded, tiered_from_padded
from repro_torch.data.store import DatasetStore

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
PLANS = ["vmap", "sequential"]


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _same(got, want, msg=""):
    for name in ("w", "gaps", "coords"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(), \
            f"{msg}: {name}"
    assert got.stop_step_or() == want.stop_step_or(), msg
    assert got.stop_reason == want.stop_reason, msg


def _spans(tel):
    return [e["name"] for e in tel.events if e["ev"] == "span"]


def test_grid_fields_equal_jax():
    kw = dict(lam=(1.0, 2.0, 3.0), epsilon=(0.1, 1.0), seed=7, steps=10, queue="two_level")
    got = grid(FWConfig(backend="torch_sparse"), **kw)
    want = jax_grid(JaxConfig(backend="jax_sparse"), **kw)
    assert len(got) == len(want) == 6
    shared = [f.name for f in dataclasses.fields(FWConfig)
              if f.name not in ("backend", "device")]
    for g, w in zip(got, want):
        assert {k: getattr(g, k) for k in shared} == {k: getattr(w, k) for k in shared}
    assert [c.lam for c in got] == [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
    assert len(grid(lam=5.0)) == 1                       # scalars only: one config
    assert grid(lambdas=(3.0, 2.0))[0].lambdas == (3.0, 2.0)   # one path is a value
    assert len(grid(lambdas=((3.0, 2.0), (4.0, 1.0)))) == 2    # a sequence sweeps paths
    with pytest.raises(ValueError, match="unknown FWConfig field"):
        grid(lambda_=(1.0,))


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_solve_many_equals_solve(problem, loss, private, plan):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=30, loss=loss, delta=1e-6,
                            device="cpu", queue="two_level" if private else None),
                   lam=(4.0, 8.0, 16.0), epsilon=(0.5, 2.0))
    with obs.session() as tel:
        got = solve_many(host, y, configs, plan=plan)
    assert f"group.{plan}" in _spans(tel) and "solve_many" in _spans(tel)
    for i, cfg in enumerate(configs):
        _same(got[i], solve(host, y, cfg), f"{loss} {cfg.lam} {cfg.epsilon}")


@pytest.mark.parametrize("plan", PLANS)
def test_varied_seeds_draw_their_own_keys(problem, plan):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=25, queue="bsls", lam=8.0,
                            epsilon=1.0, device="cpu"), seed=(0, 1, 2, 3))
    got = solve_many(host, y, configs, plan=plan)
    for res, cfg in zip(got, configs):
        _same(res, solve(host, y, cfg), f"seed {cfg.seed}")
    assert len({tuple(r.coords.tolist()) for r in got}) > 1


def test_mixed_backends_keep_input_order(problem):
    _, host, y = problem
    configs = [FWConfig(backend="dense", lam=8.0, steps=12, device="cpu"),
               FWConfig(backend="torch_sparse", lam=8.0, steps=12, device="cpu"),
               FWConfig(backend="jax_sparse", lam=4.0, steps=12, device="cpu"),
               FWConfig(backend="dense", lam=4.0, steps=12, selection="gumbel", device="cpu"),
               FWConfig(backend="torch_sparse", lam=4.0, steps=12, queue="two_level",
                        device="cpu"),
               FWConfig(backend="auto", lam=6.0, steps=12, device="cpu")]
    got = solve_many(host, y, configs, plan="vmap")
    assert len(got) == len(configs)
    for cfg, res in zip(configs, got):
        _same(res, solve(host, y, cfg), cfg.backend)


def test_empty_and_singleton(problem):
    _, host, y = problem
    assert solve_many(host, y, []) == []
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=10, device="cpu")
    for plan in PLANS:
        one = solve_many(host, y, [cfg], plan=plan)
        assert len(one) == 1
        _same(one[0], solve(host, y, cfg), "singleton")


@pytest.mark.parametrize("plan", PLANS)
def test_store_input_equals_in_memory(problem, tmp_path, plan):
    _, host, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "ds"), host, y, rows_per_shard=64)
    configs = grid(FWConfig(backend="torch_sparse", steps=20, queue="two_level",
                            device="cpu"), lam=(5.0, 9.0), seed=(0, 1))
    got = solve_many(store, configs=configs, plan=plan)
    mem = solve_many(host, y, configs, plan=plan)
    for cfg, a, b in zip(configs, got, mem):
        _same(a, b, "store vs memory")
        _same(a, solve(store, config=cfg), "store solve")


def _tol(gaps: np.ndarray, k: int) -> float:
    """A tolerance > 0 midway between two gap values of the trace (or 0 and
    the least positive one) at least 2e-6 apart, whose first crossing lies
    nearest step k (``tests/test_torch_stopping.py``'s rule)."""
    pos = np.unique(gaps[gaps > 0]).astype(np.float64)
    cands = [0.5 * pos[0]] if pos[0] > 2e-6 else []
    cands += [0.5 * (a + b) for a, b in zip(pos[:-1], pos[1:]) if b - a > 2e-6]
    first = lambda tol: int(np.argmax(gaps <= np.float32(tol)))
    return min(cands, key=lambda tol: abs(first(tol) - k))


def _tols(problem, private):
    """gap_tols of a grid of λ whose first crossings land near different
    steps of each config's own fixed-T trace.  ε is large, so that a private
    draw rarely takes a coordinate whose α is 0 (its gap is then 0, and any
    tolerance would stop the run at once)."""
    _, host, y = problem
    tols = []
    for k, lam in zip((6, 13, 22, 29), (4.0, 8.0, 12.0, 16.0)):
        full = solve(host, y, FWConfig(backend="torch_sparse", lam=lam, steps=30,
                                       device="cpu", epsilon=1e4,
                                       queue="two_level" if private else None))
        tols.append(_tol(full.gaps.numpy(), k))
    return tols


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("private", [False, True])
def test_gap_tol_grid_retires_each_config_at_its_own_step(problem, private, plan):
    _, host, y = problem
    tols = _tols(problem, private)
    configs = [FWConfig(backend="torch_sparse", lam=lam, steps=30, gap_tol=tol, chunk_steps=4,
                        device="cpu", epsilon=1e4, queue="two_level" if private else None)
               for lam, tol in zip((4.0, 8.0, 12.0, 16.0), tols)]
    with obs.session() as tel:
        got = solve_many(host, y, configs, plan=plan)
    stops = []
    for cfg, res in zip(configs, got):
        _same(res, solve(host, y, cfg), f"lam {cfg.lam}")
        stops.append(res.stop_step_or())
    assert any(res.stop_reason == STOP_GAP_TOL for res in got)
    assert len(set(stops)) > 1, stops
    if plan == "vmap":
        retired = [e for e in tel.events if e["ev"] == "event" and e["name"] == "cohort.retire"]
        assert sorted(e["attrs"]["config"] for e in retired) == [0, 1, 2, 3]
        assert [e["attrs"]["stop_step"] for e in sorted(
            retired, key=lambda e: e["attrs"]["config"])] == stops
        assert "group.cohort" in _spans(tel)


def test_cohort_max_seconds_counts_from_the_first_chunk(problem):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=20, chunk_steps=5, max_seconds=0.0,
                            device="cpu"), lam=(4.0, 8.0, 12.0))
    got = solve_many(host, y, configs, plan="vmap")
    for res in got:
        assert (res.stop_step_or(), res.stop_reason) == (5, STOP_MAX_SECONDS)
        assert (res.coords[5:] == -1).all() and (res.coords[:5] >= 0).all()


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("layout", ["flat", "tiered"])
def test_takes_the_jax_coordinates(problem, private, layout):
    X, host, y = problem
    kw = dict(steps=30, delta=1e-6, queue="two_level" if private else None)
    axes = dict(lam=(4.0, 8.0, 16.0), epsilon=(0.5, 2.0))
    want = jax_solve_many(X, y, jax_grid(JaxConfig(backend="jax_sparse", **kw), **axes))
    pcsr, pcsc = host_to_padded(host, "cpu")
    data = (pcsr, pcsc if layout == "flat" else tiered_from_padded(pcsc, 8))
    for plan in PLANS:
        got = solve_many(data, y, grid(FWConfig(backend="torch_sparse", device="cpu", **kw),
                                       **axes), plan=plan)
        for i, (g, w) in enumerate(zip(got, want)):
            msg = f"{plan} {layout} config {i}"
            np.testing.assert_array_equal(g.coords.numpy(), np.asarray(w.coords), err_msg=msg)
            np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), rtol=0, atol=1e-4,
                                       err_msg=msg)
            np.testing.assert_allclose(g.gaps.numpy(), np.asarray(w.gaps), rtol=0, atol=1e-4,
                                       err_msg=msg)


@pytest.mark.parametrize("field,value,item", [("mesh", (2, 2), "A12")])
def test_unported_configs_refused_before_compute(problem, field, value, item):
    """``mesh`` is ported (ROADMAP.md item ``item``).  On a torch_sparse
    config it names nothing that engine reads: the config runs as its own
    solve.  A jax_shard config whose grid needs more ranks than this process
    has is refused."""
    _, host, y = problem
    configs = [FWConfig(backend="torch_sparse", steps=5, device="cpu"),
               FWConfig(backend="torch_sparse", steps=5, device="cpu", **{field: value})]
    for cfg, res in zip(configs, solve_many(host, y, configs)):
        own = solve(host, y, cfg)
        for name in ("w", "gaps", "coords"):
            assert torch.equal(getattr(res, name), getattr(own, name)), name
    with pytest.raises(ValueError, match="needs 4 devices"):
        solve_many(host, y, [FWConfig(backend="jax_shard", steps=5, device="cpu",
                                      **{field: value})])


@pytest.mark.parametrize("field,value", [("lambdas", (8.0, 4.0)), ("screen_every", 1)])
def test_screened_and_path_groups_run(problem, field, value):
    """A screened group and a λ-path group run under ``solve_many`` and give
    each config its own ``solve``'s result (a ``PathResult`` for a path)."""
    _, host, y = problem
    configs = [FWConfig(backend="torch_sparse", steps=24, chunk_steps=8, device="cpu",
                        queue="two_level", epsilon=eps, seed=seed, lam=8.0, **{field: value})
               for eps, seed in ((1.0, 0), (4.0, 3))]
    for plan in PLANS:
        got = solve_many(host, y, configs, plan=plan)
        for i, (g, c) in enumerate(zip(got, configs)):
            want = solve(host, y, c)
            for a, b in (zip(g, want) if field == "lambdas" else [(g, want)]):
                _same(a, b, f"{field} {plan} config {i}")


def test_bogus_plan_raises(problem):
    _, host, y = problem
    cfg = [FWConfig(backend="torch_sparse", steps=2, device="cpu")]
    for plan in ("turbo", SolvePlan(mode="turbo"), 3):
        with pytest.raises(ValueError, match="plan"):
            solve_many(host, y, cfg, plan=plan)


def test_plan_chunk_overrides_the_default(problem):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=20, gap_tol=1e-30, device="cpu"),
                   lam=(4.0, 8.0, 12.0))
    runs = {}
    for name, plan in (("5", SolvePlan(mode="vmap", chunk_steps=5)),
                       ("20", SolvePlan(mode="vmap", chunk_steps=20)),
                       ("seq", "sequential")):
        with obs.session() as tel:
            runs[name] = solve_many(host, y, configs, plan=plan)
        if name != "seq":
            chunks = [m for m in tel.metrics.snapshot() if m["name"] == "cohort.chunk.seconds"]
            assert chunks and chunks[0]["count"] == 20 // int(name)
    for a, b, c in zip(runs["5"], runs["20"], runs["seq"]):
        _same(a, b, "chunk 5 vs 20")
        _same(a, c, "cohort vs sequential")


def test_auto_plan_follows_the_cost_book(problem):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=10, device="cpu"), lam=(4.0, 8.0))
    stats = planner.data_stats(host_to_padded(host, "cpu"))
    planner.clear_costbook()
    try:
        with obs.session() as tel:
            first = solve_many(host, y, configs)
        assert "group.sequential" in _spans(tel)       # the CPU's default
        for _ in range(2):
            planner.record_cost("torch_sparse", "vmap", "torch-cpu", stats, 1e-9)
            planner.record_cost("torch_sparse", "sequential", "torch-cpu", stats, 1.0)
        with obs.session() as tel:
            second = solve_many(host, y, configs)
        assert "group.vmap" in _spans(tel)
        for a, b in zip(first, second):
            _same(a, b, "auto plans")
    finally:
        planner.clear_costbook()


def test_telemetry_leaves_the_iterates(problem):
    _, host, y = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=15, gap_tol=1e-4, chunk_steps=4,
                            queue="two_level", device="cpu"), lam=(4.0, 8.0, 16.0))
    quiet = solve_many(host, y, configs, plan="vmap")
    with obs.session():
        loud = solve_many(host, y, configs, plan="vmap")
    for a, b in zip(quiet, loud):
        _same(a, b, "telemetry")


def test_prepared_cache_coerces_once(problem, monkeypatch):
    _, host, y = problem
    cache = {}
    configs = grid(FWConfig(backend="torch_sparse", steps=5, device="cpu"), lam=(4.0, 8.0))
    solve_many(host, y, configs, prepared=cache)
    assert list(cache) == [("padded", "cpu")]
    from repro_torch.core.solvers import registry
    monkeypatch.setattr(registry, "host_to_padded", lambda *a: pytest.fail("coerced again"))
    solve_many(host, y, configs, prepared=cache)
    assert isinstance(cache[("padded", "cpu")][1], type(host_to_padded(host, "cpu")[1]))
    assert torch.equal(cache[("padded", "cpu")][0].nnz, host_to_padded(host, "cpu")[0].nnz)
