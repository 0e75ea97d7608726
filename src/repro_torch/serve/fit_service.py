"""DP-LASSO fit service of the port: slot-based request/response engine over
``solve_many`` (``repro.serve.fit_service``).

The same lifecycle as the JAX service — **submit → admit → batch → drain**
— for multi-tenant DP-LASSO fit requests against one resident design matrix:

  * **submit** queues a ``FitRequest`` (tenant + FWConfig);
  * **admit** refuses, before any compute, what the request's backend cannot
    run (its queue, the gap certificate, ``max_seconds``, screening and
    λ-paths, a ``mesh``, which names ROADMAP.md item A12), resolves
    ``backend="auto"`` through the planner and the queue name, and for a
    private queue charges the tenant's ``PrivacyAccountant``; a refused
    request is charged nothing.  The charge is in the accountant's own step
    currency: T_req selections at (ε_req, δ) cost
    ``ceil(T_req · (ε'_req/ε'_acct)²)`` tenant steps, plus the planned
    screening rounds (``_charged_steps``);
  * **batch** packs admitted requests into sweep groups
    (``batched.group_key``) of at most ``slots`` configs;
  * **drain** runs each slot-batch through ``solve_many``: a ``torch_sparse``
    batch as lanes (one launch of ``coord_update_lanes`` and
    ``two_level_draw_lanes`` a step) or as the planner says; ``dense``,
    ``torch_dense`` and ``host_sparse`` batches config by config.  The
    service keeps one resolved source and ``solve_many``'s ``prepared`` cache
    for its lifetime, so each data layout is coerced once (the padded pair
    up front, on ``FitServiceConfig.device``).

A request's result equals its own ``solve`` bit for bit.  Telemetry records
the JAX spans and counters (``service.run``, ``service.batch``,
``service.submitted``/``admitted``/``rejected``/``finished``,
``service.batch_failures``, the queue-depth gauge, the latency histogram);
every charge and refusal is an ``AuditLedger`` entry, appended to
``ledger_path`` when it is set.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Mapping, Optional

from repro_torch import obs
from repro_torch.core.dp.accountant import PrivacyAccountant, per_step_epsilon
from repro_torch.core.solvers.batched import group_key, solve_many
from repro_torch.core.solvers.config import FWConfig, FWResult, check_gap_certificate, \
    check_supported
from repro_torch.core.solvers.registry import (as_padded, check_device, check_path_support,
                                               check_screening_support, get_backend,
                                               resolve_data, resolve_queue)
from repro_torch.obs.ledger import AuditLedger
from repro_torch.obs.metrics import quantile

# Native queue/selection names that consume privacy budget (the DP
# exponential mechanism and report-noisy-max realizations, per backend).
PRIVATE_QUEUES = frozenset({"bsls", "two_level", "gumbel", "noisy_max"})


@dataclasses.dataclass
class FitRequest:
    uid: int
    tenant: str
    config: FWConfig
    # filled by the service
    status: str = "queued"            # queued | done | rejected | failed
    reason: str = ""                  # set when rejected/failed
    result: Optional[FWResult] = None
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_s(self) -> float:
        return max(self.finished_at - self.submitted_at, 0.0)


@dataclasses.dataclass(frozen=True)
class FitServiceConfig:
    slots: int = 8                    # max configs per drained batch
    # ε-spend audit trail: None keeps the ledger in memory only; a path
    # appends every charge/refusal as JSONL (a restarted service continues it)
    ledger_path: Optional[str] = None
    device: str = "cuda"              # where the resident padded pair lives


class FitService:
    """Multi-tenant DP-LASSO fitting over one resident (X, y) dataset."""

    def __init__(self, X, y=None,
                 accountants: Optional[Mapping[str, PrivacyAccountant]] = None,
                 config: FitServiceConfig = FitServiceConfig()):
        if config.slots < 1:
            raise ValueError("slots must be >= 1")
        device = str(check_device(config.device))
        # the resolved source stays, so that a request's backend coerces its
        # own layout once (solve_many fills the cache); the padded pair — the
        # common case — is coerced here
        X, y = resolve_data(X, y)
        self._source = X
        self._coerced: Dict[tuple, object] = {("padded", device): as_padded(X, device)}
        self.X = self._coerced[("padded", device)]
        self.y = y
        self._stats = None                 # planner ProblemStats, lazy
        self.accountants: Dict[str, PrivacyAccountant] = dict(accountants or {})
        self.cfg = config
        self.queue: List[FitRequest] = []
        self.finished: List[FitRequest] = []
        self.batches_run = 0
        self.batch_sizes: List[int] = []
        self.serving_s = 0.0              # wall-clock actually spent draining
        # every accountant's attach state is the base of its replay chain
        self.ledger = AuditLedger(config.ledger_path)
        for tenant, acct in sorted(self.accountants.items()):
            self.ledger.open_tenant(tenant, acct)

    # ------------------------------------------------------------------ public
    def submit(self, req: FitRequest) -> None:
        req.submitted_at = time.time()
        req.status = "queued"
        self.queue.append(req)
        obs.count("service.submitted", tenant=req.tenant)
        obs.gauge("service.queue_depth", len(self.queue))

    def run(self) -> List[FitRequest]:
        """Drain the queue; returns every request (done/rejected/failed)."""
        with obs.span("service.run", queued=len(self.queue)):
            admitted = [r for r in self.queue if self._admit(r)]
            rejected = [r for r in self.queue if r.status == "rejected"]
            self.queue = []
            obs.gauge("service.queue_depth", 0)
            for batch in self._pack(admitted):
                self._drain(batch)
        done = sorted(admitted + rejected, key=lambda r: r.uid)
        for r in done:
            obs.count("service.finished", status=r.status)
            if r.status == "done":
                obs.observe("service.latency_s", r.latency_s)
        self.finished.extend(done)
        return done

    def stats(self) -> dict:
        """Per-request latency, throughput and per-tenant accountant state."""
        done = [r for r in self.finished if r.status == "done"]
        lat = [r.latency_s for r in done]
        return {
            "requests": len(self.finished),
            "done": len(done),
            "rejected": sum(r.status == "rejected" for r in self.finished),
            "failed": sum(r.status == "failed" for r in self.finished),
            "batches": self.batches_run,
            "batch_sizes": list(self.batch_sizes),
            "queue_depth": len(self.queue),
            "latency_s": {
                "p50": quantile(lat, 0.50),
                "p90": quantile(lat, 0.90),
                "p99": quantile(lat, 0.99),
                "max": max(lat) if lat else 0.0,
            },
            # over drain time only: idle time between run() calls is not serving
            "throughput_fits_per_s": (
                len(done) / self.serving_s if self.serving_s > 0 else 0.0),
            "tenants": {
                t: {"spent_steps": a.spent_steps,
                    "remaining_steps": a.remaining_steps,
                    "spent_epsilon": a.spent_epsilon()}
                for t, a in self.accountants.items()},
        }

    def verify_ledger(self) -> Dict[str, dict]:
        """Audit the ε-spend ledger against the live accountants (exact;
        raises on any drift: ``AuditLedger.verify``)."""
        return self.ledger.verify(self.accountants)

    def checkpoint_accountants(self, directory: str) -> str:
        """Snapshot accountant state (``repro_torch.checkpoint``) so that a
        restart resumes from audited spend (pair with ``ledger_path``)."""
        return self.ledger.checkpoint(directory, self.accountants)

    # --------------------------------------------------------------- internals
    def _planned_backend(self, cfg: FWConfig) -> str:
        """The planner's backend for ``cfg`` against the resident dataset
        (stats from the resolved source, derived once)."""
        from repro_torch.core.solvers.planner import choose_backend, data_stats
        if self._stats is None:
            self._stats = data_stats(self._source)
        return choose_backend(self._stats, cfg)

    def _admit(self, req: FitRequest) -> bool:
        """Validate the config, resolve the queue, and charge the tenant for
        private fits.  A refusal leaves the accountant untouched (``spend``
        raises before it mutates), and a request is charged only once it can
        no longer fail validation."""
        try:
            cfg = req.config
            check_supported(cfg)                    # mesh → A12
            if cfg.backend == "auto":
                cfg = dataclasses.replace(cfg, backend=self._planned_backend(cfg))
            backend = get_backend(cfg.backend)
            cfg = dataclasses.replace(cfg, backend=backend.name)
            if cfg.max_seconds is not None and not backend.supports_max_seconds:
                # the adapter would raise this at drain time, after the
                # charge and failing its whole batch; refuse it here instead
                raise ValueError(
                    f"backend {backend.name!r} runs as one compiled scan "
                    "and cannot enforce max_seconds; use gap_tol or a "
                    "chunked backend")
            if cfg.screen_every:
                from repro_torch.core.solvers.screening import check_screen_config
                check_screen_config(cfg)
            check_screening_support(backend, cfg)
            if cfg.lambdas is not None:
                from repro_torch.core.solvers.path import check_path_config
                check_path_config(cfg)
            check_path_support(backend, cfg)
            resolved = resolve_queue(backend, cfg)
            # unknown loss → KeyError; gap_tol on a non-smooth objective →
            # ValueError: both refused here, before any budget is charged
            check_gap_certificate(resolved)
        except (ValueError, KeyError, NotImplementedError) as e:
            return self._reject(req, str(e))
        req.config = resolved
        # the effective selection rule: the dense adapter runs `queue` when
        # one was given, else its `selection`
        if resolved.queue is not None:
            effective = resolved.queue
        elif backend.name == "dense":
            effective = resolved.selection
        else:
            effective = None
        if effective in PRIVATE_QUEUES:
            acct = self.accountants.get(req.tenant)
            if acct is None:
                return self._reject(req, f"tenant {req.tenant!r} has no privacy budget")
            try:
                # bad (ε, δ, T) raise here, before the budget is touched
                steps = self._charged_steps(acct, resolved)
                before = AuditLedger.state_of(acct)
                acct.spend(steps)
            except (RuntimeError, ValueError) as e:
                return self._reject(req, str(e))
            self.ledger.charge(tenant=req.tenant, uid=req.uid, steps=steps, before=before,
                               acct=acct, request=self._request_facts(resolved))
        obs.count("service.admitted", tenant=req.tenant)
        return True

    @staticmethod
    def _request_facts(cfg: FWConfig) -> dict:
        """The request facts a later audit needs to read a charge.  Never
        raises (the refusal path records them too): screening and paths give
        their raw knobs only."""
        facts = {"epsilon": cfg.epsilon, "delta": cfg.delta, "steps": cfg.steps,
                 "queue": cfg.queue, "backend": cfg.backend, "loss": cfg.loss}
        if cfg.screen_every:
            facts["screen_every"] = cfg.screen_every
            facts["screen_eps_frac"] = cfg.screen_eps_frac
        if cfg.lambdas is not None:
            facts["lambdas"] = [float(l) for l in cfg.lambdas]
        return facts

    @staticmethod
    def _charged_steps(acct: PrivacyAccountant, cfg: FWConfig) -> int:
        """Tenant steps consumed by a fit of T_req selections at its own
        per-step rate ε'_req = ε_req/√(8·T_req·log(1/δ)).

        Under advanced composition ε grows as ε'·√k, so the pool of T_acct
        steps at ε'_acct is charged ``T_req · (ε'_req/ε'_acct)²`` (the 1e-9
        absorbs float slop before ceil).  A δ weaker than the accountant's is
        refused.  Screening splits ε: the T selections run at the solve share
        ε·(1 − screen_eps_frac) and each of the R planned rounds is one more
        query at ε_round, priced the same way and charged up front.  A λ-path
        runs Σ budgets selections at one rate (``path_plan``).
        """
        if cfg.delta > acct.delta * (1.0 + 1e-12):
            raise ValueError(
                f"request δ={cfg.delta:g} is weaker than the tenant "
                f"accountant's δ={acct.delta:g}")
        if cfg.lambdas is not None:
            from repro_torch.core.solvers.path import path_plan
            pplan = path_plan(cfg, private=True)
            ratio = pplan.eps_per_step / acct.per_step
            return max(1, math.ceil(pplan.total_steps * ratio * ratio - 1e-9))
        from repro_torch.core.solvers.screening import screen_plan
        plan = screen_plan(cfg, private=True)
        eps_req_step = per_step_epsilon(plan.eps_solve, cfg.delta, cfg.steps)
        ratio = eps_req_step / acct.per_step
        charged = max(1, math.ceil(cfg.steps * ratio * ratio - 1e-9))
        if plan.rounds:
            sratio = plan.eps_round / acct.per_step
            charged += max(1, math.ceil(plan.rounds * sratio * sratio - 1e-9))
        return charged

    def _reject(self, req: FitRequest, reason: str) -> bool:
        req.status, req.reason = "rejected", reason
        req.finished_at = time.time()
        # every refusal is a ledger fact: charge-free, with the tenant's
        # (unchanged) accountant state when one exists
        self.ledger.refusal(tenant=req.tenant, uid=req.uid, reason=reason,
                            acct=self.accountants.get(req.tenant),
                            request=self._request_facts(req.config))
        obs.count("service.rejected", tenant=req.tenant)
        return False

    def _pack(self, admitted: List[FitRequest]) -> List[List[FitRequest]]:
        """Group compatible configs, then chop each group to ``slots``."""
        groups: Dict[tuple, List[FitRequest]] = {}
        for r in admitted:
            groups.setdefault(group_key(r.config), []).append(r)
        batches = []
        for members in groups.values():
            for i in range(0, len(members), self.cfg.slots):
                batches.append(members[i:i + self.cfg.slots])
        return batches

    def _drain(self, batch: List[FitRequest]) -> None:
        t0 = time.time()
        try:
            with obs.span("service.batch", size=len(batch), backend=batch[0].config.backend):
                results = solve_many(self._source, self.y, [r.config for r in batch],
                                     prepared=self._coerced)
        except Exception as e:  # noqa: BLE001 — one bad batch must not strand the rest
            # The charged budget is not refunded: admission cannot prove how
            # far the mechanism got before failing.
            now = time.time()
            obs.count("service.batch_failures")
            for req in batch:
                req.status = "failed"
                req.reason = f"solver error: {e}"
                req.finished_at = now
            self.serving_s += now - t0
            return
        now = time.time()
        for req, res in zip(batch, results):
            req.result = res
            req.status = "done"
            req.finished_at = now
        self.serving_s += now - t0
        self.batches_run += 1
        self.batch_sizes.append(len(batch))
