"""Warm-started λ-paths (``repro.core.solvers.path``).

``solve_path(X, y, lambdas=(λ₀ > λ₁ > ...), config=...)`` solves a strictly
decreasing λ-sequence from one setup: each λ starts from the previous λ's
whole carry.  The carried state (w/w_m, v̄/q̄/α, g̃, the sampler, the key)
does not depend on λ, which enters each step as a scalar, so every segment
runs the same chunk loop and continues the global 2/(t+2) schedule.

Budgets and ε are fixed up front (``path_plan``): ``planner.path_budgets``
gives the first λ the full ``config.steps`` and later λs the warm fraction;
segment k holds the global step slots [S_{k-1}, S_k) even when its gap
certificate stops it early.  A private path is one mechanism of
T_total = Σ T_k selections at the rate ε' = ε/√(8·T_total·log(1/δ)); segment
k's share ε_k = ε·√(T_k/T_total) gives per_step_epsilon(ε_k, δ, T_k) = ε'
for every k, so one EM scale serves the whole path.

The result is a :class:`PathResult` of one ``FWResult`` per λ.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs, prng
from repro_torch.core.dp.accountant import em_log_weight_scale, per_step_epsilon
from repro_torch.core.solvers.config import (FWConfig, FWResult, check_gap_certificate,
                                             check_supported)
from repro_torch.core.solvers.planner import path_budgets
from repro_torch.core.solvers.registry import (check_device, check_path_support, get_backend,
                                               labels_on, resolve_data, resolve_queue)
from repro_torch.core.solvers.stopping import assemble_outputs, drive_chunks, resolve_chunk


def check_path_config(config: FWConfig) -> None:
    """Refuse a malformed λ-path config up front."""
    lambdas = config.lambdas
    if lambdas is None or len(lambdas) == 0:
        raise ValueError("a λ-path needs a non-empty lambdas sequence "
                         "(FWConfig(lambdas=(λ₀, λ₁, ...)))")
    if any(l <= 0 for l in lambdas):
        raise ValueError(f"path lambdas must be positive; got {lambdas}")
    if any(b >= a for a, b in zip(lambdas, lambdas[1:])):
        raise ValueError(
            "path lambdas must be strictly decreasing (the warm start "
            f"continues from inside the shrinking L1 ball); got {lambdas}")
    if config.screen_every > 0:
        raise ValueError(
            "screening (screen_every > 0) cannot be combined with a λ-path: "
            "coordinates screened out at one λ may re-enter at a smaller λ, "
            "so the §13 drop rule is unsound mid-path — screen per λ "
            "separately or set screen_every=0")
    if config.max_seconds is not None:
        raise ValueError(
            "max_seconds is ambiguous for a multi-λ path (per segment or "
            "whole path?) and would break the deterministic up-front "
            "ε split — use gap_tol for per-λ early stopping instead")


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """Budgets, step slots and ε split of one λ-path, from the config alone."""

    lambdas: Tuple[float, ...]
    budgets: Tuple[int, ...]        # per-λ iteration budgets (planner)
    offsets: Tuple[int, ...]        # global step slot each segment starts at
    total_steps: int                # Σ budgets = EM selections composed
    eps_per_step: float             # uniform per-selection rate ε'; 0.0 non-private
    eps_lambdas: Tuple[float, ...]  # per-λ ε share: ε_k = ε·sqrt(T_k/T_tot)


def path_plan(config: FWConfig, *, private: bool) -> PathPlan:
    """Budgets and the ε split for ``config.lambdas``; a non-private plan
    keeps the full ε per segment (unused)."""
    check_path_config(config)
    lambdas = config.lambdas
    budgets = path_budgets(config.steps, len(lambdas))
    offsets, acc = [], 0
    for b in budgets:
        offsets.append(acc)
        acc += b
    total = acc
    if not private:
        return PathPlan(lambdas=lambdas, budgets=budgets, offsets=tuple(offsets),
                        total_steps=total, eps_per_step=0.0,
                        eps_lambdas=(config.epsilon,) * len(lambdas))
    eps_step = per_step_epsilon(config.epsilon, config.delta, total)
    eps_lams = tuple(config.epsilon * math.sqrt(b / total) for b in budgets)
    return PathPlan(lambdas=lambdas, budgets=budgets, offsets=tuple(offsets),
                    total_steps=total, eps_per_step=eps_step, eps_lambdas=eps_lams)


def segment_config(config: FWConfig, plan: PathPlan, k: int) -> FWConfig:
    """The single-λ config of segment ``k``: λ_k at budget T_k and share ε_k.
    Segment 0 of a path equals ``solve(X, y, segment_config(cfg, plan, 0))``
    bit for bit; later segments differ by their warm carry."""
    return dataclasses.replace(config, lam=plan.lambdas[k], steps=plan.budgets[k],
                               epsilon=plan.eps_lambdas[k], lambdas=None)


class PathResult:
    """A solved λ-path: one ``FWResult`` per λ and the plan that priced it."""

    def __init__(self, lambdas: Tuple[float, ...], results: Sequence[FWResult],
                 plan: PathPlan):
        self.lambdas = tuple(lambdas)
        self.results = tuple(results)
        self.plan = plan

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, k: int) -> FWResult:
        return self.results[k]

    @property
    def final(self) -> FWResult:
        """The smallest-λ (last) solution."""
        return self.results[-1]

    def __repr__(self) -> str:
        return (f"PathResult(K={len(self.results)}, lambdas={self.lambdas}, "
                f"total_steps={self.plan.total_steps})")


def _final_gap(result: FWResult) -> float:
    gaps = result.gaps_valid
    return float(gaps[-1]) if gaps.shape[0] else float("nan")


def _emit_lambda_event(k: int, lam: float, plan: PathPlan, result: FWResult,
                       seconds: float) -> None:
    if not obs.enabled():
        return
    obs.event("path.lambda", index=k, lam=float(lam), budget=plan.budgets[k],
              offset=plan.offsets[k], stop_step=result.stop_step_or(plan.budgets[k]),
              stop_reason=result.stop_reason, gap=_final_gap(result),
              eps_lambda=float(plan.eps_lambdas[k]), seconds=seconds)


def path_em_scale(config: FWConfig, plan: PathPlan, n_rows: int) -> float:
    """The one EM scale of a private path, taken through segment 0's
    (ε₀, T₀), so it is the scale a ``solve`` of ``segment_config(cfg, plan,
    0)`` computes."""
    if config.queue != "two_level":
        return 1.0
    return em_log_weight_scale(epsilon=plan.eps_lambdas[0], delta=config.delta,
                               steps=plan.budgets[0], n_rows=n_rows,
                               lipschitz=config.loss_fn().lipschitz)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def torch_sparse_path(pcsr, pcsc, y: torch.Tensor, config: FWConfig,
                      plan: Optional[PathPlan] = None, setup=None) -> PathResult:
    """A warm-started λ-path through the kernels: one setup (``ell_rmatvec``
    runs once or twice for the whole path) and one ``FWCarry`` for every
    segment.  Between segments only ``done``/``stop_at`` are reset; each
    segment runs masked chunks at the global step ``offset + t0``."""
    from repro_torch.core.solvers.autotune import platform_of
    from repro_torch.core.solvers.planner import data_stats, record_cost
    from repro_torch.core.solvers.torch_sparse import _sync, fw_carry_init, fw_scan_chunk, fw_setup
    private = config.queue == "two_level"
    if plan is None:
        plan = path_plan(config, private=private)
    n, d = pcsr.shape
    em_scale = path_em_scale(config, plan, n)
    y_scan = None if config.loss_fn().separable else y
    if setup is None:
        with obs.span("solve.setup", loss=config.loss):
            setup = fw_setup(pcsr, y, loss=config.loss, pcsc=pcsc)
    carry = fw_carry_init(d, pcsr.values.dtype, *setup, em_scale, prng.PRNGKey(config.seed),
                          private=private)
    platform = platform_of(pcsr.device)
    stats = data_stats((pcsr, pcsc))

    results: List[FWResult] = []
    for k, lam_k in enumerate(plan.lambdas):
        budget, seg_off = plan.budgets[k], plan.offsets[k]
        if k:   # warm restart: un-freeze the stop flags, keep everything else
            carry.done.fill_(False)
            carry.stop_at.zero_()

        def advance(carry, t0, c, _lam=lam_k, _off=seg_off):
            return fw_scan_chunk(pcsr, pcsc, carry, _lam, em_scale, config.gap_tol, _off + t0,
                                 y_scan, steps=c, loss=config.loss, private=private,
                                 early_stop=True)

        t_seg = time.perf_counter()
        carry, outs, stop_step, stop_reason = drive_chunks(
            advance, carry, steps=budget,
            chunk=resolve_chunk(dataclasses.replace(config, steps=budget)), max_seconds=None,
            done_of=lambda cy: cy.done, stop_at_of=lambda cy, _off=seg_off: cy.stop_at - _off)
        _sync(carry.w.device)
        dt = time.perf_counter() - t_seg
        record_cost("torch_sparse", "sequential", platform, stats, dt / max(stop_step, 1),
                    loss=config.loss)
        gaps, coords = assemble_outputs(outs, budget, (0.0, -1))
        result = FWResult(w=carry.w * carry.w_m, gaps=gaps, coords=coords,
                          losses=torch.zeros_like(gaps), stop_step=stop_step,
                          stop_reason=stop_reason)
        results.append(result)
        _emit_lambda_event(k, lam_k, plan, result, dt)
    return PathResult(plan.lambdas, results, plan)


def dense_path(X, y: torch.Tensor, config: FWConfig,
               plan: Optional[PathPlan] = None) -> PathResult:
    """A warm-started λ-path of Alg 1, whose carry is (w, key, done,
    stop_at): each segment builds its step from ``segment_config`` (Alg 1
    takes its noise scales from the config) and carries w and the key."""
    from repro_torch.core.fw_dense import _carry0, _dense_chunk, _dense_step, _shape
    from repro_torch.core.solvers.torch_sparse import _sync
    if config.queue is not None:   # a queue name selects the Alg 1 rule
        config = dataclasses.replace(config, selection=config.queue, queue=None)
    private = config.selection in ("noisy_max", "gumbel")
    if plan is None:
        plan = path_plan(config, private=private)
    carry = _carry0(X, _shape(X)[1], config)

    results: List[FWResult] = []
    for k, lam_k in enumerate(plan.lambdas):
        budget, seg_off = plan.budgets[k], plan.offsets[k]
        seg_cfg = segment_config(config, plan, k)
        masked = seg_cfg.gap_tol > 0
        step = _dense_step(X, y, seg_cfg, masked)
        if k:
            carry = (carry[0], carry[1], torch.zeros_like(carry[2]),
                     torch.zeros_like(carry[3]))

        def advance(carry, t0, c, _step=step, _off=seg_off, _masked=masked):
            return _dense_chunk(_step, carry, _off + t0, c, masked=_masked)

        t_seg = time.perf_counter()
        carry, outs, stop_step, stop_reason = drive_chunks(
            advance, carry, steps=budget, chunk=resolve_chunk(seg_cfg), max_seconds=None,
            done_of=lambda cy: cy[2], stop_at_of=lambda cy, _off=seg_off: cy[3] - _off)
        _sync(carry[0].device)
        dt = time.perf_counter() - t_seg
        gaps, coords, losses = assemble_outputs(outs, budget, (0.0, -1, 0.0))
        result = FWResult(w=carry[0], gaps=gaps, coords=coords, losses=losses,
                          stop_step=stop_step, stop_reason=stop_reason)
        results.append(result)
        _emit_lambda_event(k, lam_k, plan, result, dt)
    return PathResult(plan.lambdas, results, plan)


def run_path(backend, data, y: torch.Tensor, config: FWConfig) -> PathResult:
    """One coerced, queue-resolved path config on its backend's driver.  A
    dataset store (``PreparedDataset``) replays its cached setup and applies
    its tuning record, as a ``torch_sparse`` solve does."""
    if backend.name == "torch_sparse":
        from repro_torch.core.solvers.backends import torch_sparse_operands
        pcsr, pcsc, setup, config = torch_sparse_operands(data, y, config)
        return torch_sparse_path(pcsr, pcsc, y, config, setup=setup)
    if backend.name == "dense":
        return dense_path(data, y, config)
    raise ValueError(f"backend {backend.name!r} has no path driver")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def solve_path(X, y=None, lambdas=None, config: Optional[FWConfig] = None,
               **overrides) -> PathResult:
    """Solve a whole λ-path from one setup.

    ``lambdas`` (or ``config.lambdas``) is the strictly decreasing sequence;
    everything else — the data accepted, queue names, ``backend="auto"``,
    ``device`` — behaves as in ``solve``.  Returns a :class:`PathResult`.
    With telemetry on it records the span ``solve_path``, the counter
    ``path.solves`` and one ``path.lambda`` event per λ.
    """
    config = config or FWConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    if lambdas is not None:
        config = dataclasses.replace(config, lambdas=tuple(lambdas))
    if config.lambdas is None:
        raise ValueError("solve_path needs a λ-sequence: pass lambdas=... "
                         "or a config with lambdas set")
    check_supported(config)
    with obs.span("solve_path", loss=config.loss, n_lambdas=len(config.lambdas)) as sp:
        check_gap_certificate(config)
        check_path_config(config)
        device = check_device(config.device)
        X, y = resolve_data(X, y)
        if config.backend == "auto":
            with obs.span("solve.plan"):
                from repro_torch.core.solvers.planner import choose_backend, data_stats
                config = dataclasses.replace(
                    config, backend=choose_backend(data_stats(X), config))
        backend = get_backend(config.backend)
        check_path_support(backend, config)
        config = resolve_queue(backend, config)
        sp.set(backend=backend.name, queue=config.queue)
        obs.count("path.solves", backend=backend.name)
        with obs.span("solve.coerce", layout=backend.data_format):
            data = backend.prepare(X, device)
            y = labels_on(y, device)
        with obs.span("solve.run", backend=backend.name):
            return run_path(backend, data, y, config)

