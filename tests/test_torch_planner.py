"""The port's planner against the JAX package's (``solvers/planner.py``).

The same matrix, made from a seed, goes through both packages: the port's
``data_stats`` and ``store_stats`` equal JAX's for flat, tiered, dense, host
and store inputs, and, for equal stats, ``step_costs``, ``default_chunk``,
``path_budgets``, ``cohort_widths``, ``choose_backend`` and ``group_mode``
give JAX's answers, the JAX platform ``cpu`` read as the port's
``torch-cpu`` and the name ``jax_sparse`` as ``torch_sparse``.  The cost
book discards the first observation, then averages (EWMA 0.7/0.3).
``backend="auto"`` equals the backend it picks bit for bit, and
``get_backend`` names each unported backend's ROADMAP.md item.
"""
import dataclasses
import subprocess
import sys

import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import planner as jplanner
from repro.core.sparse import formats as jf
from repro.data.store import DatasetStore as JaxStore
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, SolvePlan, grid, obs, plan_for, solve
from repro_torch.core.solvers import get_backend
from repro_torch.core.solvers import planner
from repro_torch.core.sparse.formats import HostCSR, host_to_padded, tiered_from_padded
from repro_torch.data.store import DatasetStore

JAX_NAME = {"jax_sparse": "torch_sparse", "dense": "dense"}


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=120, d=500, nnz_per_row=8, informative=12, seed=3)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


@pytest.fixture()
def fresh_book():
    """Empty cost books in both packages (other tests in the process record)."""
    planner.clear_costbook()
    jplanner.clear_costbook()
    yield
    planner.clear_costbook()
    jplanner.clear_costbook()


def _fields(stats):
    return (stats.n, stats.d, stats.nnz, stats.kc, stats.kr)


@pytest.mark.parametrize("layout", ["host", "flat", "tiered", "dense", "dense_tensor"])
def test_data_stats_equal_jax(problem, layout):
    X, host, _ = problem
    if layout == "host":
        got, want = planner.data_stats(host), jplanner.data_stats(X)
    elif layout == "flat":
        got = planner.data_stats(host_to_padded(host, "cpu"))
        want = jplanner.data_stats(jf.host_to_padded(X))
    elif layout == "tiered":
        pcsr, pcsc = host_to_padded(host, "cpu")
        jcsr, jcsc = jf.host_to_padded(X)
        got = planner.data_stats((pcsr, tiered_from_padded(pcsc, 8)))
        want = jplanner.data_stats((jcsr, jf.tiered_from_padded(jcsc, 8)))
    elif layout == "dense":
        got, want = planner.data_stats(X.to_dense()), jplanner.data_stats(X.to_dense())
    else:
        got = planner.data_stats(torch.from_numpy(X.to_dense()))
        want = jplanner.data_stats(X.to_dense())
    assert _fields(got) == _fields(want)
    assert got.density == want.density


@pytest.mark.parametrize("legacy", [False, True])
def test_store_stats_equal_jax_and_never_materialize(problem, tmp_path, monkeypatch, legacy):
    X, host, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "port"), host, y, rows_per_shard=40)
    jstore = JaxStore.from_arrays(str(tmp_path / "jax"), X, y, rows_per_shard=40)
    if legacy:   # stores written before the row/col max manifest keys
        for s in (store, jstore):
            s.manifest.pop("row_nnz_max")
            s.manifest.pop("col_nnz_max")
    planner._STORE_STATS.clear()
    jplanner._STORE_STATS.clear()
    monkeypatch.setattr(DatasetStore, "to_host_csr", lambda self: (_ for _ in ()).throw(
        AssertionError("data_stats materialized the store")))
    got = planner.data_stats(store)
    assert _fields(got) == _fields(jplanner.data_stats(jstore)) == \
        _fields(jplanner.data_stats(X))
    assert planner.data_stats(store) is got     # cached per content hash
    planner._STORE_STATS.clear()


STATS = [jplanner.ProblemStats(n=2000, d=500_000, nnz=80_000, kc=64, kr=40),
         jplanner.ProblemStats(n=80, d=50, nnz=4000, kc=80, kr=50),
         jplanner.ProblemStats(n=20242, d=47236, nnz=1497342, kc=20242, kr=111),
         jplanner.ProblemStats(n=120, d=500, nnz=960, kc=31, kr=8)]


def _port(stats):
    return planner.ProblemStats(**dataclasses.asdict(stats))


@pytest.mark.parametrize("stats", STATS, ids=["sparse", "small_dense", "rcv1", "tiny"])
def test_cost_model_equals_jax_on_cpu(stats, fresh_book):
    for jname, name in JAX_NAME.items():
        assert planner.step_costs(_port(stats), name) == jplanner.step_costs(stats, jname)
        assert planner.step_time_model(_port(stats), name, "torch-cpu") == \
            jplanner.step_time_model(stats, jname, "cpu")
    for loss in ("logistic", "lad"):
        cfg = dict(loss=loss, steps=100)
        assert planner.choose_backend(_port(stats), FWConfig(**cfg), "torch-cpu") == \
            JAX_NAME[jplanner.choose_backend(stats, JaxConfig(**cfg), "cpu")]
    for size in (1, 2, 8):
        assert planner.group_mode(_port(stats), size, platform="torch-cpu") == \
            jplanner.group_mode(stats, size, platform="cpu")
        # the card: no measurement yet, so the lane constant decides, as on the TPU
        assert planner.group_mode(_port(stats), size, platform="torch-cuda") == \
            jplanner.group_mode(stats, size, platform="tpu")


def test_choose_backend_regimes_on_both_platforms(fresh_book):
    sparse, dense = _port(STATS[0]), _port(STATS[1])
    assert planner.choose_backend(sparse, FWConfig(), "torch-cpu") == "torch_sparse"
    assert planner.choose_backend(dense, FWConfig(), "torch-cpu") == "dense"
    # the card sets no model against a measurement: torch_sparse until both
    # steps are measured, then the cheaper one
    for stats in (sparse, dense):
        assert planner.choose_backend(stats, FWConfig(), "torch-cuda") == "torch_sparse"
    planner.record_measured("dense", "sequential", "torch-cuda", dense, 1e-12)
    assert planner.choose_backend(dense, FWConfig(), "torch-cuda") == "torch_sparse"
    planner.record_measured("torch_sparse", "sequential", "torch-cuda", dense, 1.0)
    assert planner.choose_backend(dense, FWConfig(), "torch-cuda") == "dense"
    planner.record_measured("dense", "sequential", "torch-cuda", dense, 2.0)
    assert planner.choose_backend(dense, FWConfig(), "torch-cuda") == "torch_sparse"
    with pytest.raises(NotImplementedError, match="A12"):
        planner.choose_backend(sparse, FWConfig(mesh=(2, 2)), "torch-cpu")
    # the platform follows the config's device when none is given
    assert planner.choose_backend(sparse, FWConfig(device="cpu")) == "torch_sparse"


@pytest.mark.parametrize("steps", [1, 3, 8, 64, 100, 500, 4000, 10_000])
def test_chunks_budgets_and_widths_equal_jax(steps):
    assert planner.default_chunk(steps) == jplanner.default_chunk(steps)
    for k in (0, 1, 3, 5):
        assert planner.path_budgets(steps, k) == jplanner.path_budgets(steps, k)
    width = steps % 13 + 1
    assert planner.cohort_widths(width) == jplanner.cohort_widths(width)


def test_costbook_discards_first_then_ewma(fresh_book):
    stats = _port(STATS[3])
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cpu", stats) is None
    planner.record_cost("torch_sparse", "vmap", "torch-cpu", stats, 999.0)   # discarded
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cpu", stats) is None
    planner.record_cost("jax_sparse", "vmap", "torch-cpu", stats, 1.0)        # the alias
    planner.record_cost("torch_sparse", "vmap", "torch-cpu", stats, 0.0)
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cpu", stats) == \
        pytest.approx(0.7)
    assert planner.measured_cost("jax_sparse", "vmap", "torch-cpu", stats) == pytest.approx(0.7)
    # the autotuner's steady-state reading replaces the entry outright
    planner.record_measured("torch_sparse", "vmap", "torch-cpu", stats, 0.25)
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cpu", stats) == 0.25
    # keyed per loss and platform
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cpu", stats,
                                 loss="lad") is None
    assert planner.measured_cost("torch_sparse", "vmap", "torch-cuda", stats) is None


def test_measured_costs_override_the_mode_and_backend_models(fresh_book):
    stats = _port(STATS[2])
    assert planner.group_mode(stats, 8, platform="torch-cpu") == "sequential"
    for _ in range(2):       # the first observation per key is discarded
        planner.record_cost("torch_sparse", "vmap", "torch-cpu", stats, 0.001)
        planner.record_cost("torch_sparse", "sequential", "torch-cpu", stats, 0.010)
    assert planner.group_mode(stats, 8, platform="torch-cpu") == "vmap"
    assert planner.group_mode(stats, 8, platform="torch-cpu", backend="dense") == "sequential"
    assert planner.group_mode(stats, 8, SolvePlan(mode="sequential"),
                              platform="torch-cpu") == "sequential"
    model = planner.choose_backend(stats, FWConfig(), "torch-cpu")
    other = "dense" if model == "torch_sparse" else "torch_sparse"
    planner.record_measured(other, "sequential", "torch-cpu", stats, 1e-12)
    planner.record_measured(model, "sequential", "torch-cpu", stats, 1.0)
    assert planner.choose_backend(stats, FWConfig(), "torch-cpu") == other


def test_drift_gauge_only_with_telemetry(fresh_book):
    stats = _port(STATS[3])
    with obs.session() as tel:
        planner.record_measured("torch_sparse", "sequential", "torch-cpu", stats, 1e-3)
    names = {m["name"] for m in tel.metrics.snapshot()}
    assert {"planner.drift", "planner.step_seconds"} <= names
    planner.record_measured("torch_sparse", "sequential", "torch-cpu", stats, 1e-3)


def test_plan_for_and_resolved_mode(problem, fresh_book):
    _, host, _ = problem
    cfgs = grid(FWConfig(backend="torch_sparse", steps=64, device="cpu"), lam=(1.0, 2.0))
    plan = plan_for(host, cfgs)
    assert plan.mode == plan.resolved_mode("torch-cpu") == "sequential"
    assert plan.chunk_steps == planner.default_chunk(64) == 8
    assert "grid=2" in plan.notes and "platform=torch-cpu" in plan.notes
    assert plan_for(host, cfgs, platform="torch-cuda").mode == "vmap"
    assert SolvePlan().resolved_mode("torch-cuda") == "vmap"
    assert plan_for(host, ()).chunk_steps is None


@pytest.mark.parametrize("queue", [None, "two_level"])
def test_solve_auto_backend_equals_its_pick(problem, queue, fresh_book):
    X, host, y = problem
    cfg = FWConfig(backend="auto", lam=8.0, steps=15, device="cpu", queue=queue)
    pick = planner.choose_backend(planner.data_stats(host), cfg)
    jpick = jplanner.choose_backend(jplanner.data_stats(X), JaxConfig(), "cpu")
    assert pick == JAX_NAME[jpick]
    with obs.session() as tel:
        auto = solve(host, y, cfg)
    assert any(e["name"] == "solve.plan" for e in tel.events if e["ev"] == "span")
    explicit = solve(host, y, dataclasses.replace(cfg, backend=pick))
    for name in ("w", "gaps", "coords"):
        assert torch.equal(getattr(auto, name), getattr(explicit, name)), name


@pytest.mark.parametrize("name,item,exc", [
    ("host_sparse", "A9", None), ("jax_dense", "A9", None),
    ("jax_shard", "A12", NotImplementedError), ("auto", "resolved", ValueError),
    ("no_such_engine", "unknown", ValueError)])
def test_get_backend_names_each_unported_item(name, item, exc):
    if exc is None:   # ported (A9): the JAX name resolves to the port's engine
        assert get_backend(name).name == {"jax_dense": "torch_dense"}.get(name, name)
    else:
        with pytest.raises(exc, match=item):
            get_backend(name)
    assert get_backend("jax_sparse") is get_backend("torch_sparse")
    assert get_backend("jax_dense") is get_backend("torch_dense")


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "import repro_torch.core.solvers, repro_torch.roofline\n"
            "import repro_torch.core.solvers.planner, repro_torch.core.solvers.batched\n"
            "import repro_torch.core.solvers.autotune, repro_torch.roofline.analysis\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
