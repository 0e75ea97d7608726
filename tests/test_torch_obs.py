"""The port's telemetry and audit ledger against the JAX package's ``repro.obs``.

The same inputs go through both packages: quantiles and metric snapshots
equal exactly, the JSONL records and the Prometheus text are the same text,
a ledger either package wrote replays and verifies exactly in the other, and
an accountant checkpoint either package wrote restores in the other.  A
solve with telemetry on equals one with it off bit for bit, on every path
the port has.
"""
import io
import json
import os
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.checkpoint.checkpointer import restore_pytree as jax_restore
from repro.checkpoint.checkpointer import save_pytree as jax_save
from repro.core.dp.accountant import PrivacyAccountant as JaxAccountant
from repro.obs import exporters as jax_exporters
from repro.obs import report as jax_report
from repro.obs.ledger import AuditLedger as JaxLedger
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch import FWConfig, obs, solve
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core.dp.accountant import PrivacyAccountant
from repro_torch.data.synthetic import make_sparse_classification
from repro_torch.obs import exporters, report
from repro_torch.obs.ledger import AuditLedger
from repro_torch.obs.metrics import MetricsRegistry

PACKAGES = {
    "repro": dict(obs=jax_obs, ledger=JaxLedger, acct=JaxAccountant, save=jax_save,
                  restore=jax_restore),
    "repro_torch": dict(obs=obs, ledger=AuditLedger, acct=PrivacyAccountant, save=save_pytree,
                        restore=restore_pytree),
}
DIRECTIONS = [("repro", "repro_torch"), ("repro_torch", "repro")]


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_quantile_equals_the_jax_packages(q, n):
    values = list(np.random.default_rng(n).normal(size=n))
    assert obs.quantile(values, q) == jax_obs.quantile(values, q)
    if n:
        assert obs.quantile(values, q) == pytest.approx(float(np.quantile(values, q)))


def test_quantile_refuses_q_outside_unit_interval():
    with pytest.raises(ValueError, match="quantile q"):
        obs.quantile([1.0], 1.5)


def _drive(tel_module, registry=None):
    """The same instrument calls against either package (no wall clock)."""
    reg = registry
    for i in range(5):
        reg.counter("store.cache", cache="padded", outcome="hit" if i % 2 else "miss").inc()
        reg.gauge("chunk.first_seconds").set(0.25 * i)
        reg.histogram("chunk.seconds", backend="torch_sparse").observe(0.1 * i + 0.05)
    reg.counter("solve.calls", backend="dense").inc(3)
    return reg


def test_metrics_snapshot_equals_the_jax_packages():
    assert (_drive(obs, MetricsRegistry()).snapshot()
            == _drive(jax_obs, JaxRegistry()).snapshot())


def _session_records(pkg):
    """A session with spans, events and metrics, its timings zeroed."""
    o = PACKAGES[pkg]["obs"]
    with o.session(meta={"run": "t"}) as tel:
        with o.span("solve", loss="logistic") as sp:
            sp.set(backend="torch_sparse")
            with o.span("solve.run"):
                o.event("chunks.stop", stop_step=3, stop_reason="gap_tol")
        o.count("solve.calls", 2, backend="dense")
        o.gauge("chunk.first_seconds", 0.5)
        for v in (0.1, 0.2, 0.4):
            o.observe("chunk.seconds", v)
    tel.wall_start = 0.0
    for e in tel.events:
        e["ts"] = 0.0
        if "dur_s" in e:
            e["dur_s"] = 0.0
    return tel


def test_jsonl_and_prometheus_text_equal_the_jax_packages(tmp_path):
    ours, theirs = _session_records("repro_torch"), _session_records("repro")
    assert exporters.prometheus_text(ours) == jax_exporters.prometheus_text(theirs)
    assert ours.events == theirs.events
    assert ours.metrics.snapshot() == theirs.metrics.snapshot()
    # the JSONL file one package writes, the other reads and renders alike
    for writer, tel in (("repro_torch", ours), ("repro", theirs)):
        path = str(tmp_path / f"{writer}.jsonl")
        (exporters if writer == "repro_torch" else jax_exporters).write_jsonl(tel, path)
        a, b = exporters.read_jsonl(path), jax_exporters.read_jsonl(path)
        assert a == b and a[0]["ev"] == "meta" and a[0]["run"] == "t"
        assert report.render(a) == jax_report.render(b)
        out = io.StringIO()
        with redirect_stdout(out):
            assert report.main([path]) == 0
        assert "span tree" in out.getvalue() and "solve.run" in out.getvalue()


def test_disabled_telemetry_records_nothing():
    assert not obs.enabled() and obs.get() is None
    with obs.span("x") as sp:
        sp.set(a=1)
    obs.count("c")
    obs.gauge("g", 1.0)
    obs.observe("h", 1.0)
    obs.event("e")
    tel = obs.enable({"k": 1})
    try:
        obs.count("c")
        assert obs.get() is tel and tel.metrics.counter("c").value == 1
    finally:
        assert obs.disable() is tel
    assert not obs.enabled()


# ---------------------------------------------------------------------------
# telemetry leaves the iterates alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=400, nnz_per_row=9, informative=12, seed=8)
    return X, y


@pytest.mark.parametrize("backend,queue,gap_tol", [
    ("torch_sparse", "two_level", 0.0), ("torch_sparse", "group_argmax", 0.0),
    ("dense", None, 0.0), ("torch_sparse", "group_argmax", 1e-4), ("dense", None, 1e-4)])
def test_solve_with_telemetry_equals_solve_without(problem, backend, queue, gap_tol):
    X, y = problem
    cfg = FWConfig(backend=backend, queue=queue, lam=10.0, steps=40, gap_tol=gap_tol,
                   chunk_steps=8 if gap_tol else None, device="cpu")
    off = solve(X, y, cfg)
    with obs.session() as tel:
        on = solve(X, y, cfg)
    for k in ("coords", "w", "gaps", "losses"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    assert on.stop_step_or() == off.stop_step_or() and on.stop_reason == off.stop_reason
    spans = [e["name"] for e in tel.events if e["ev"] == "span"]
    assert spans == ["solve.coerce", "solve.run", "solve"]
    names = {m["name"] for m in tel.metrics.snapshot()}
    assert "solve.calls" in names
    if gap_tol:
        stops = [e for e in tel.events if e["name"] == "chunks.stop"]
        assert len(stops) == 1 and stops[0]["attrs"]["stop_step"] == on.stop_step_or()
        assert {"chunk.first_seconds", "chunk.steps", "chunks.stopped"} <= names


# ---------------------------------------------------------------------------
# the audit ledger and accountant checkpoints across packages
# ---------------------------------------------------------------------------


def _write_ledger(pkg, path):
    ns = PACKAGES[pkg]
    accts = {"acme": ns["acct"](epsilon=1.0, delta=1e-6, total_steps=400),
             "beta": ns["acct"](epsilon=0.5, delta=1e-5, total_steps=100, spent_steps=20)}
    led = ns["ledger"](path)
    for t, a in accts.items():
        led.open_tenant(t, a)
    for uid, (t, steps) in enumerate((("acme", 100), ("beta", 30), ("acme", 50))):
        before = led.state_of(accts[t])
        accts[t].spend(steps)
        led.charge(tenant=t, uid=uid, steps=steps, before=before, acct=accts[t],
                   request={"epsilon": 0.1, "steps": steps, "queue": "bsls"})
    led.refusal(tenant="beta", uid=9, reason="budget", acct=accts["beta"])
    return led, accts


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_ledger_replays_and_verifies_exactly_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "ledger.jsonl")
    led, accts = _write_ledger(writer, path)
    other = PACKAGES[reader]["ledger"](path)         # continues the same file
    assert other.entries == led.entries
    assert other.totals() == led.totals()
    mirror = {t: PACKAGES[reader]["acct"](**a.to_state()) for t, a in accts.items()}
    report_ = other.verify(mirror)
    assert report_["acme"]["spent_steps"] == 150 and report_["acme"]["exact"]
    assert report_["acme"]["spent_epsilon"] == accts["acme"].spent_epsilon()
    # a corrupted transition is caught by both packages
    entries = [dict(e) for e in led.entries]
    entries[3] = dict(entries[3], after=dict(entries[3]["after"], spent_steps=999))
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="moved"):
            pkg["ledger"].replay(entries)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_accountant_checkpoint_restores_across_packages(tmp_path, writer, reader):
    led, accts = _write_ledger(writer, str(tmp_path / "ledger.jsonl"))
    path = led.checkpoint(str(tmp_path / "ckpt"), accts)
    assert os.path.basename(path) == f"accountants_{len(led.entries)}.npz"
    with open(path + ".meta.json") as f:
        assert json.load(f)["kind"] == "privacy_accountants"
    restored = PACKAGES[reader]["ledger"].restore_accountants(path)
    assert {t: a.to_state() for t, a in restored.items()} == \
        {t: a.to_state() for t, a in accts.items()}
    assert restored["acme"].spent_epsilon() == accts["acme"].spent_epsilon()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_save_pytree_layout_is_the_jax_packages(tmp_path, writer, reader):
    tree = {"b": {"z": np.arange(3.0), "a": [np.ones(2, np.float32), np.int64(7)]},
            "a": np.zeros((2, 2), np.int32), "c": (np.array(True),), "n": None}
    paths = {}
    for pkg in ("repro", "repro_torch"):
        paths[pkg] = str(tmp_path / pkg / "t.npz")
        PACKAGES[pkg]["save"](tree, paths[pkg], metadata={"step": 3})
    names = [zipfile.ZipFile(p).namelist() for p in paths.values()]
    assert names[0] == names[1] == ["a.npy", "b/a/0.npy", "b/a/1.npy", "b/z.npy", "c/0.npy"]
    got = PACKAGES[reader]["restore"](tree, paths[writer])
    for key, ref in (("a", tree["a"]), ("z", tree["b"]["z"])):
        val = got[key] if key == "a" else got["b"]["z"]
        np.testing.assert_array_equal(np.asarray(val), ref)
    assert np.asarray(got["b"]["a"][0]).dtype == np.float32


def test_restore_pytree_into_tensors(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree({"w": torch.arange(4.0), "k": [torch.tensor(3)]}, path)
    got = restore_pytree({"w": torch.zeros(4, dtype=torch.float64), "k": [torch.tensor(0)]},
                         path)
    assert got["w"].dtype == torch.float64 and torch.equal(got["w"], torch.arange(4.0).double())
    assert int(got["k"][0]) == 3
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree({"w": torch.zeros(5), "k": [torch.tensor(0)]}, path)
