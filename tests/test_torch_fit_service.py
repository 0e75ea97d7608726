"""The port's ``FitService`` against the JAX package's, on the CPU (the
counterparts of ``tests/test_fit_service.py``, the service cases of
``tests/test_dp.py`` and of ``tests/test_early_stop.py``).

* One request stream through both services — private lane batches over the
  budget, non-private fits on every backend, refusals of each kind — gives
  the same status and reason per request (the reasons name each package's
  backends), the same charges, accountant state and ledger totals, and JAX's
  coordinates for every answered request.
* Every answered request equals its own port ``solve`` bit for bit.
* A refused request is charged nothing; the ledger verifies; a drain that
  fails marks its batch failed and the rest still runs.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core.dp.accountant import PrivacyAccountant as JaxAccountant
from repro.core.solvers import FWConfig as JaxConfig
from repro.serve import FitRequest as JaxRequest
from repro.serve import FitService as JaxService
from repro.serve import FitServiceConfig as JaxServiceConfig
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, grid, obs, solve
from repro_torch.core.dp.accountant import PrivacyAccountant
from repro_torch.core.losses import OBJECTIVES, LOGISTIC
from repro_torch.core.sparse.formats import HostCSR
from repro_torch.serve import FitRequest, FitService, FitServiceConfig

STEPS = 15
PORT_NAME = {"jax_sparse": "torch_sparse", "jax_dense": "torch_dense"}


@pytest.fixture(scope="module")
def service_problem():
    X, y, _ = make_sparse_classification(n=120, d=500, nnz_per_row=10, informative=12, seed=21)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _budgets(acct_cls):
    # acme (ε=6, 144 steps): ε=0.5 fits cost 1, ε=2 fits 16; globex (ε=1, 45
    # steps): ε=0.5 fits cost 12, so a fourth is refused
    return {"acme": acct_cls(epsilon=6.0, delta=1e-6, total_steps=144),
            "globex": acct_cls(epsilon=1.0, delta=1e-6, total_steps=45)}


def _service(host, y, slots=4, **kw):
    return FitService(host, y, _budgets(PrivacyAccountant),
                      FitServiceConfig(slots=slots, device="cpu", **kw))


def _port_config(**kw) -> FWConfig:
    kw = dict(kw)
    kw["backend"] = PORT_NAME.get(kw.get("backend"), kw.get("backend", "dense"))
    return FWConfig(device="cpu", **kw)


def _stream():
    """(tenant, config kwargs) of a mixed stream, in submission order."""
    out = [("acme", dict(backend="jax_sparse", steps=STEPS, queue="bsls", delta=1e-6, lam=lam,
                         epsilon=eps)) for lam in (4.0, 8.0, 16.0, 32.0) for eps in (0.5, 2.0)]
    out += [("globex", dict(backend="jax_sparse", steps=STEPS, queue="bsls", epsilon=0.5,
                            lam=lam)) for lam in (4.0, 8.0, 16.0, 32.0)]   # the 4th: refused
    out += [("globex", dict(backend="jax_sparse", steps=STEPS, lam=lam)) for lam in (4.0, 8.0)]
    out += [
        ("acme", dict(backend="jax_dense", lam=8.0, steps=STEPS)),
        ("acme", dict(backend="jax_dense", lam=8.0, steps=STEPS, queue="two_level",
                      epsilon=0.5)),
        ("acme", dict(backend="host_sparse", lam=8.0, steps=STEPS)),
        ("acme", dict(backend="host_sparse", lam=8.0, steps=STEPS, queue="noisy_max",
                      epsilon=0.5)),
        ("acme", dict(backend="dense", lam=8.0, steps=STEPS, selection="gumbel", epsilon=0.5)),
        ("acme", dict(backend="jax_sparse", lam=8.0, steps=STEPS, gap_tol=1e-3)),
        ("acme", dict(backend="jax_dense", lam=8.0, steps=STEPS, queue="two_level",
                      epsilon=0.5, max_seconds=5.0)),                    # refused
        ("acme", dict(backend="jax_dense", steps=STEPS, screen_every=2)),   # refused
        ("acme", dict(backend="host_sparse", steps=STEPS, lambdas=(8.0, 4.0))),   # refused
        ("acme", dict(backend="jax_sparse", steps=STEPS, queue="bogus")),   # refused
        ("acme", dict(backend="jax_sparse", steps=STEPS, queue="bsls", epsilon=0.0)),
    ]
    return out


def _port_reason(reason: str) -> str:
    for jax_name, port_name in PORT_NAME.items():
        reason = reason.replace(jax_name, port_name)
    return reason


def test_same_stream_same_answers_as_jax(service_problem):
    X, host, y = service_problem
    jsvc = JaxService(X, y, _budgets(JaxAccountant), JaxServiceConfig(slots=4))
    tsvc = _service(host, y)
    for uid, (tenant, kw) in enumerate(_stream()):
        jsvc.submit(JaxRequest(uid=uid, tenant=tenant, config=JaxConfig(**kw)))
        tsvc.submit(FitRequest(uid=uid, tenant=tenant, config=_port_config(**kw)))
    jdone, tdone = jsvc.run(), tsvc.run()
    assert [r.uid for r in tdone] == [r.uid for r in jdone] == list(range(len(_stream())))
    for j, t in zip(jdone, tdone):
        assert (t.status, t.reason) == (j.status, _port_reason(j.reason)), t.uid
        if j.status == "done":
            np.testing.assert_array_equal(t.result.coords.numpy(), np.asarray(j.result.coords))
            np.testing.assert_allclose(t.result.w.numpy(), np.asarray(j.result.w), atol=1e-4)
            assert t.result.stop_step_or() == j.result.stop_step_or()
    rejected = [t.uid for t in tdone if t.status == "rejected"]
    assert rejected == [11, 20, 21, 22, 23, 24]
    assert tsvc.stats()["tenants"] == jsvc.stats()["tenants"]
    got, want = tsvc.verify_ledger(), jsvc.verify_ledger()
    assert got == want and all(rec["exact"] for rec in got.values())
    charges = lambda svc: [(e["tenant"], e["uid"], e["steps"]) for e in svc.ledger.entries
                           if e["kind"] == "charge"]
    assert charges(tsvc) == charges(jsvc)


def test_every_answer_equals_its_own_solve(service_problem):
    _, host, y = service_problem
    svc = _service(host, y)
    stream = _stream()[:20]   # the answered kinds
    for uid, (tenant, kw) in enumerate(stream):
        svc.submit(FitRequest(uid=uid, tenant=tenant, config=_port_config(**kw)))
    for r in svc.run():
        if r.status != "done":
            continue
        ref = solve(host, y, dataclasses.replace(r.config))
        for name in ("w", "gaps", "coords"):
            assert torch.equal(getattr(r.result, name), getattr(ref, name)), (r.uid, name)
        assert r.result.stop_step_or() == ref.stop_step_or()


def test_fit_service_end_to_end(service_problem):
    _, host, y = service_problem
    svc = _service(host, y)
    uid = 0
    for tenant, kw in _stream()[:14]:
        svc.submit(FitRequest(uid=uid, tenant=tenant, config=_port_config(**kw)))
        uid += 1
    done = svc.run()
    rej = [r for r in done if r.status == "rejected"]
    assert [r.uid for r in rej] == [11] and "budget exhausted" in rej[0].reason
    assert rej[0].result is None
    assert svc.accountants["acme"].spent_steps == 4 * 1 + 4 * 16
    assert svc.accountants["acme"].spent_epsilon() == pytest.approx(6.0 * math.sqrt(68 / 144))
    assert svc.accountants["globex"].spent_steps == 3 * 12
    stats = svc.stats()
    assert stats["requests"] == 14 and stats["done"] == 13 and stats["rejected"] == 1
    assert stats["throughput_fits_per_s"] > 0
    assert stats["latency_s"]["max"] >= stats["latency_s"]["p50"] > 0
    assert all(1 <= b <= 4 for b in stats["batch_sizes"]) and sum(stats["batch_sizes"]) == 13


def test_charged_steps_is_epsilon_squared_equivalent():
    acct = PrivacyAccountant(epsilon=2.0, delta=1e-6, total_steps=64)
    charge = FitService._charged_steps
    assert charge(acct, FWConfig(epsilon=0.5, delta=1e-6, steps=10)) == 4
    assert charge(acct, FWConfig(epsilon=0.5, delta=1e-6, steps=1000)) == 4
    assert charge(acct, FWConfig(epsilon=2.0, delta=1e-6, steps=64)) == 64
    assert charge(acct, FWConfig(epsilon=4.0, delta=1e-6, steps=10)) == 256
    jacct = JaxAccountant(epsilon=2.0, delta=1e-6, total_steps=64)
    for kw in (dict(screen_every=2, screen_eps_frac=0.3), dict(lambdas=(8.0, 4.0, 2.0))):
        cfg = dict(epsilon=0.7, delta=1e-6, steps=40, **kw)
        assert charge(acct, FWConfig(**cfg)) == JaxService._charged_steps(jacct, JaxConfig(**cfg))
    with pytest.raises(ValueError, match="weaker than"):
        charge(acct, FWConfig(epsilon=0.5, delta=1e-3, steps=10))


def test_dense_nonprivate_queue_not_charged(service_problem):
    _, host, y = service_problem
    svc = _service(host, y)
    svc.submit(FitRequest(uid=0, tenant="acme", config=FWConfig(
        backend="dense", steps=5, queue="argmax", selection="gumbel", device="cpu")))
    assert svc.run()[0].status == "done" and svc.accountants["acme"].spent_steps == 0
    svc.submit(FitRequest(uid=1, tenant="acme", config=FWConfig(
        backend="dense", steps=5, selection="gumbel", device="cpu")))
    assert svc.run()[0].status == "done" and svc.accountants["acme"].spent_steps > 0


def test_drain_failure_does_not_strand_queue(service_problem, monkeypatch):
    import repro_torch.serve.fit_service as fs
    _, host, y = service_problem
    svc = _service(host, y, slots=2)
    real, calls = fs.solve_many, {"n": 0}

    def flaky(X, y, configs, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected solver crash")
        return real(X, y, configs, **kwargs)

    monkeypatch.setattr(fs, "solve_many", flaky)
    for i, lam in enumerate((4.0, 8.0, 16.0, 32.0)):
        svc.submit(FitRequest(uid=i, tenant="acme", config=_port_config(
            backend="jax_sparse", lam=lam, steps=5)))
    done = svc.run()
    assert [r.status for r in done] == ["failed", "failed", "done", "done"]
    assert all("injected solver crash" in r.reason for r in done if r.status == "failed")
    assert svc.stats()["failed"] == 2 and svc.stats()["done"] == 2


def test_slot_width_one_and_bad_slots(service_problem):
    _, host, y = service_problem
    svc = _service(host, y, slots=1)
    for i, cfg in enumerate(grid(FWConfig(backend="torch_sparse", steps=STEPS, device="cpu"),
                                 lam=(4.0, 8.0))):
        svc.submit(FitRequest(uid=i, tenant="acme", config=cfg))
    assert all(r.status == "done" for r in svc.run())
    assert svc.stats()["batch_sizes"] == [1, 1]
    with pytest.raises(ValueError, match="slots"):
        FitService(host, y, {}, FitServiceConfig(slots=0, device="cpu"))


def test_refusals_are_charge_free(service_problem):
    """Non-smooth gap_tol, max_seconds on torch_dense, a mesh (A12), an
    unknown tenant, ε ≤ 0: each refused before any charge; the good
    request beside them runs and is the only charge."""
    _, host, y = service_problem
    probe = dataclasses.replace(LOGISTIC, name="_svc_abs_probe", smooth=False,
                                curvature_note="|m-y| kink at 0")
    OBJECTIVES[probe.name] = probe
    try:
        svc = _service(host, y)
        bad = [("acme", dict(backend="jax_sparse", steps=STEPS, queue="bsls", epsilon=0.5,
                             loss="_svc_abs_probe", gap_tol=1e-3)),
               ("acme", dict(backend="torch_dense", steps=STEPS, queue="bsls", epsilon=0.5,
                             max_seconds=5.0)),
               ("acme", dict(backend="torch_sparse", steps=STEPS, queue="bsls", mesh=(2, 2))),
               ("acme", dict(backend="jax_shard", steps=STEPS, queue="bsls")),
               ("stranger", dict(backend="torch_sparse", steps=STEPS, queue="bsls")),
               ("acme", dict(backend="torch_sparse", steps=5, queue="bsls", epsilon=0.0))]
        for uid, (tenant, kw) in enumerate(bad):
            svc.submit(FitRequest(uid=uid, tenant=tenant, config=_port_config(**kw)))
        good = _port_config(backend="torch_dense", lam=8.0, steps=20, queue="bsls", epsilon=1.0)
        svc.submit(FitRequest(uid=len(bad), tenant="acme", config=good))
        done = {r.uid: r for r in svc.run()}
        assert [done[i].status for i in range(len(bad))] == ["rejected"] * len(bad)
        assert "not smooth" in done[0].reason and "max_seconds" in done[1].reason
        assert "A12" in done[2].reason and "A12" in done[3].reason
        assert "no privacy budget" in done[4].reason
        assert done[len(bad)].status == "done"
        solo = _service(host, y)
        solo.submit(FitRequest(uid=0, tenant="acme", config=good))
        solo.run()
        assert svc.accountants["acme"].spent_steps == solo.accountants["acme"].spent_steps > 0
        refusals = [e["uid"] for e in svc.ledger.entries if e["kind"] == "refusal"]
        assert refusals == list(range(len(bad)))
        assert [e["uid"] for e in svc.ledger.entries if e["kind"] == "charge"] == [len(bad)]
    finally:
        OBJECTIVES.pop(probe.name, None)


def test_charges_full_T_for_early_stopped_fits(service_problem):
    _, host, y = service_problem
    kw = dict(backend="torch_sparse", lam=8.0, steps=30, queue="bsls", epsilon=1.0)
    fixed, adaptive = _service(host, y), _service(host, y)
    fixed.submit(FitRequest(uid=0, tenant="acme", config=_port_config(**kw)))
    adaptive.submit(FitRequest(uid=0, tenant="acme", config=_port_config(gap_tol=1e30, **kw)))
    fixed.run()
    (r,) = adaptive.run()
    assert r.status == "done" and r.result.stop_step_or() < 30
    assert adaptive.accountants["acme"].spent_steps == fixed.accountants["acme"].spent_steps


def test_auto_backend_ledger_file_and_telemetry(service_problem, tmp_path):
    _, host, y = service_problem
    path = str(tmp_path / "ledger.jsonl")
    svc = _service(host, y, ledger_path=path)
    svc.submit(FitRequest(uid=0, tenant="acme", config=_port_config(
        backend="auto", lam=8.0, steps=STEPS, queue="bsls", epsilon=0.5)))
    with obs.session() as tel:
        (r,) = svc.run()
    assert r.status == "done" and r.config.backend in ("dense", "torch_sparse")
    names = {e["name"] for e in tel.events if e["ev"] == "span"}
    assert {"service.run", "service.batch", "solve_many"} <= names
    again = FitService(host, y, svc.accountants, FitServiceConfig(device="cpu",
                                                                  ledger_path=path))
    assert len(again.ledger.entries) > len(svc.ledger.entries)   # the file is continued
    ck = svc.checkpoint_accountants(str(tmp_path / "ck"))
    from repro_torch.obs.ledger import AuditLedger
    restored = AuditLedger.restore_accountants(ck)
    assert restored["acme"].spent_steps == svc.accountants["acme"].spent_steps == 1
