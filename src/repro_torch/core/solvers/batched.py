"""Batched multi-problem solving of the port — λ/ε sweeps
(``repro.core.solvers.batched``).

Deployments sweep regularization × privacy grids over the same matrix.  Run
one by one, every problem pays its own setup (the coercion, the ȳ/α₀
``Xᵀq`` sweeps) and its own chain of launches.  ``solve_many`` shares them:

    from repro_torch.core.solvers import FWConfig, grid, solve_many
    configs = grid(FWConfig(backend="torch_sparse", steps=500, queue="two_level"),
                   lam=(10.0, 30.0, 50.0), epsilon=(0.5, 1.0))
    results = solve_many(X, y, configs)        # list[FWResult], input order

  * configs are bucketed into **sweep groups** by ``GROUP_FIELDS``
    (backend, steps, queue, loss, device, ...: what shapes the run); λ, ε,
    δ, seed, gap_tol and max_seconds vary freely inside a group;
  * ``X`` is coerced **once per data layout and device**;
  * a ``torch_sparse`` group shares one setup (``ell_rmatvec`` runs once for
    the group) and runs either as **lanes** (``plan="vmap"``: the JAX
    package's vmap becomes a leading config axis in the state and in the
    ``coord_update`` and ``two_level_draw`` kernels, so one launch of each
    serves every config of a step) or **sequentially** (per-config solves
    over the shared setup), as the planner or ``plan=`` says;
  * a group whose configs can stop early (``gap_tol``/``max_seconds``) runs
    as lanes in **cohort** chunks: between chunks each lane's ``done`` and
    ``stop_at`` are read once, finished configs retire with their own stop
    step and reason, and the survivors are repacked into a power-of-two
    width (``planner.cohort_widths``; the padding lanes are frozen copies);
  * every other group (``dense``, and singletons) drains through the
    per-config adapter on the data coerced once.

Every mode runs the same state machine with the same keys, so each config's
result equals its own ``solve`` bit for bit, whatever the plan and the
repacks.  The one schedule-dependent knob is ``max_seconds``: in cohort
mode it counts from the group's first chunk (the lanes run together), as
in the JAX package.

A screened group (``screen_every``) runs sequentially under the
``group.screened`` span whatever the plan: once a round fires, each config's
pair is its own.  A λ-path group (``lambdas``; a ``PathResult`` per config,
at its position) runs, for ``torch_sparse`` and two or more configs, as
**lanes** through the same fixed global step slots, segment by segment (each
lane with its own EM scale and key, λ_k shared, the stop flags reset between
segments, no lane retired mid-segment), or one path driver per config over
the group's one setup; other backends run ``path.run_path`` per config.
A ``jax_shard`` group of two or more shares one block layout and setup and
runs as lanes on a 1×1 mesh, one config after another on a larger one
(``jax_shard.solve_shard_group``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import obs, prng
from repro_torch.core.solvers.autotune import platform_of
from repro_torch.core.solvers.config import (STOP_GAP_TOL, STOP_MAX_SECONDS, STOP_MAX_STEPS,
                                             FWConfig, FWResult, check_gap_certificate,
                                             check_supported)
from repro_torch.core.solvers.planner import SolvePlan, record_cost
from repro_torch.core.solvers.registry import (check_device, check_path_support,
                                               check_screening_support, get_backend,
                                               labels_on, resolve_data, resolve_queue)
from repro_torch.core.solvers.torch_sparse import _sync

# FWConfig fields that must agree within one sweep group: they shape the
# run or flip a branch.  The rest — lam / epsilon / delta / seed / gap_tol /
# max_seconds — is what a group stacks.  ``device`` stands where the JAX
# package has ``interpret``.
GROUP_FIELDS = ("backend", "steps", "queue", "loss", "selection", "device", "mesh",
                "chunk_steps", "screen_every", "screen_eps_frac", "lambdas")


def grid(base: Optional[FWConfig] = None, **axes) -> Tuple[FWConfig, ...]:
    """Cartesian product of FWConfig axes, for ``solve_many``.

    Each keyword is an FWConfig field; iterable values become sweep axes
    (crossed in the order given, last axis fastest), scalars apply to every
    point; strings are scalars, never axes::

        grid(lam=(10, 30), epsilon=(0.5, 1.0), backend="torch_sparse",
             queue="two_level", steps=200)   # -> 4 configs
    """
    base = base or FWConfig()

    def _scalar(k, v):
        if isinstance(v, str) or not isinstance(v, Iterable):
            return True
        # one mesh spec (a tuple of ints) / one λ-path (a sequence of numbers)
        # is a value, not a sweep axis; a sequence of tuples sweeps them
        if k == "mesh":
            return bool(v) and all(isinstance(x, int) for x in v)
        if k == "lambdas":
            return bool(v) and all(isinstance(x, (int, float)) for x in v)
        return False

    fixed = {k: tuple(v) if k in ("mesh", "lambdas") and _scalar(k, v) and v is not None
             else v for k, v in axes.items() if _scalar(k, v)}
    sweep = {k: tuple(tuple(x) if k in ("mesh", "lambdas") else x for x in v)
             for k, v in axes.items() if k not in fixed}
    unknown = set(axes) - {f.name for f in dataclasses.fields(FWConfig)}
    if unknown:
        raise ValueError(f"unknown FWConfig field(s): {', '.join(sorted(unknown))}")
    base = dataclasses.replace(base, **fixed)
    if not sweep:
        return (base,)
    names = tuple(sweep)
    return tuple(dataclasses.replace(base, **dict(zip(names, point)))
                 for point in itertools.product(*(sweep[k] for k in names)))


def group_key(config: FWConfig) -> Tuple:
    """Sweep-group bucket of a config (backend and queue already resolved)."""
    return tuple(getattr(config, f) for f in GROUP_FIELDS)


# ---------------------------------------------------------------------------
# torch_sparse groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Group:
    """Shared operands of one ``torch_sparse`` sweep group."""

    pcsr: object
    pcsc: object
    setup: tuple
    keys: List[torch.Tensor]
    y_scan: Optional[torch.Tensor]
    private: bool
    platform: str


def _group_labels(c0: FWConfig, y: torch.Tensor) -> Optional[torch.Tensor]:
    """The labels the group's steps read: None for separable objectives."""
    return None if c0.loss_fn().separable else y


def _group_context(data, y: torch.Tensor, configs: Sequence[FWConfig]) -> _Group:
    """One setup for the whole group (a store's cached one, or one
    ``fw_setup``: ``ell_rmatvec`` runs once, not once per config), the
    store's tuned layout, and the configs' keys."""
    from repro_torch.core.solvers.backends import torch_sparse_operands
    from repro_torch.core.solvers.torch_sparse import fw_setup
    c0 = configs[0]
    pcsr, pcsc, setup, _ = torch_sparse_operands(data, y, c0)
    if setup is None:
        setup = fw_setup(pcsr, y, loss=c0.loss, pcsc=pcsc)
    return _Group(pcsr, pcsc, tuple(setup), [prng.PRNGKey(c.seed) for c in configs],
                  _group_labels(c0, y), c0.queue == "two_level", platform_of(pcsr.device))


def _group_stats(g: _Group):
    from repro_torch.core.solvers.planner import data_stats
    return data_stats((g.pcsr, g.pcsc))


def _lane_chunk(g: _Group, stats, c0: FWConfig, cur, scalars, t_step: int, steps: int,
                bufs: tuple, rows: Sequence[int], col: int, *, early_stop: bool, scratch):
    """``steps`` lane steps of the group from global step ``t_step``: one
    launch of each kernel a step for every lane.  The first ``len(rows)``
    lanes' gaps and coordinates go to those rows of ``bufs`` from column
    ``col``; the chunk's time goes to the cost book per lane-step.  Returns
    the carry, every lane's ``done`` (the read synchronises) and the
    chunk's seconds."""
    from repro_torch.core.solvers.torch_sparse import fw_scan_chunk_lanes
    tw = time.perf_counter()
    cur, outs = fw_scan_chunk_lanes(g.pcsr, g.pcsc, cur, scalars, t_step, g.y_scan, steps=steps,
                                    loss=c0.loss, private=g.private, early_stop=early_stop,
                                    scratch=scratch)
    dones = cur.done.tolist()
    dt = time.perf_counter() - tw
    record_cost(c0.backend, "vmap", g.platform, stats, dt / (steps * len(dones)), loss=c0.loss)
    ids = torch.as_tensor(rows, dtype=torch.long, device=bufs[0].device)
    for buf, out in zip(bufs, outs):
        buf[ids, col:col + steps] = out[: len(rows)]
    return cur, dones, dt


def _solve_sequential(data, y, configs: Sequence[FWConfig]) -> List[FWResult]:
    """Per-config solves over one coerced layout and one setup; each config
    stops exactly when its own certificate or budget lands."""
    from repro_torch.core.solvers.torch_sparse import torch_sparse_fw
    g = _group_context(data, y, configs)
    stats = _group_stats(g)
    out = []
    for cfg in configs:
        t0 = time.perf_counter()
        res = torch_sparse_fw(g.pcsr, g.pcsc, y, cfg, setup=g.setup)
        _sync(res.w.device)
        record_cost(cfg.backend, "sequential", g.platform, stats,
                    (time.perf_counter() - t0) / max(res.stop_step_or(cfg.steps), 1),
                    loss=cfg.loss)
        out.append(res)
    return out


def _solve_lanes(data, y, configs: Sequence[FWConfig]) -> List[FWResult]:
    """The group as lanes: every step launches each kernel once for all the
    group's configs.  A fixed-T group runs as one chunk.  A group whose
    configs can stop early runs in gap-adaptive cohort chunks: between chunks
    each lane's ``done``/``stop_at`` are read once, and configs whose
    certificate (or wall-clock budget) landed retire; the survivors are
    repacked into the next power-of-two width, padded with frozen copies of
    lane 0 whose outputs are dropped."""
    from repro_torch.core.solvers.planner import cohort_widths
    from repro_torch.core.solvers.stopping import resolve_chunk
    from repro_torch.core.solvers.torch_sparse import em_scale_for, fw_carry_init_lanes
    from repro_torch.kernels.coord_update.ops import coord_update_scratch, lane_scalars
    c0 = configs[0]
    g = _group_context(data, y, configs)
    stats = _group_stats(g)
    n_cfg, steps = len(configs), c0.steps
    cohort = any(c.early_stopping for c in configs)
    chunk = resolve_chunk(c0) if cohort else steps
    n, d = g.pcsr.shape
    dev = g.pcsr.device
    scalars = lane_scalars([c.lam for c in configs], [em_scale_for(c, n) for c in configs],
                           [c.gap_tol for c in configs], dev)
    cur = fw_carry_init_lanes(d, g.pcsr.values.dtype, *g.setup, scalars.em_scale, g.keys,
                              private=g.private)
    scratch = coord_update_scratch(n, d, dev, lanes=n_cfg) if dev.type == "cuda" else None
    gaps_buf = torch.zeros((n_cfg, steps), dtype=torch.float32, device=dev)
    coords_buf = torch.full((n_cfg, steps), -1, dtype=torch.int32, device=dev)
    final: List[Optional[FWResult]] = [None] * n_cfg
    active = list(range(n_cfg))                      # config ids, lane order
    t0 = 0
    t_start = time.perf_counter()

    def retire(lane: int, cfg_id: int, stop: int, reason: str):
        final[cfg_id] = FWResult(
            w=cur.w[lane] * cur.w_m[lane], gaps=gaps_buf[cfg_id], coords=coords_buf[cfg_id],
            losses=torch.zeros(steps, dtype=torch.float32, device=dev), stop_step=stop,
            stop_reason=reason)
        if cohort:
            obs.event("cohort.retire", config=cfg_id, stop_step=stop, stop_reason=reason,
                      survivors=len(active) - 1)
            obs.count("cohort.retired", reason=reason)

    widths = cohort_widths(n_cfg)        # power-of-two buckets, full → 1
    while active and t0 < steps:
        c = min(chunk, steps - t0)
        width = min(w for w in widths if w >= len(active))
        lane_sel = list(range(len(active))) + [0] * (width - len(active))
        padded = cur if width == len(active) else cur.take(lane_sel)
        padded.done[len(active):] = True               # padding lanes stay frozen
        padded, dones, dt = _lane_chunk(
            g, stats, c0, padded, scalars.take([active[lane] for lane in lane_sel]), t0, c,
            (gaps_buf, coords_buf), active, t0, early_stop=cohort, scratch=scratch)
        stops = padded.stop_at.tolist()[: len(active)]
        if cohort:
            obs.observe("cohort.chunk.seconds", dt)
            obs.count("cohort.chunk.steps", c * len(active))
        cur = padded if width == len(active) else padded.take(range(len(active)))
        t0 += c
        elapsed = time.perf_counter() - t_start
        keep = []
        for lane, cfg_id in enumerate(active):
            budget = configs[cfg_id].max_seconds
            timed_out = budget is not None and elapsed >= budget
            if dones[lane] or timed_out or t0 >= steps:
                reason = (STOP_GAP_TOL if dones[lane] else
                          STOP_MAX_SECONDS if timed_out else STOP_MAX_STEPS)
                retire(lane, cfg_id, stops[lane] if dones[lane] else t0, reason)
            else:
                keep.append(lane)
        if keep != list(range(len(active))):
            cur = cur.take(keep)
        active = [active[lane] for lane in keep]
    return final  # type: ignore[return-value]


def _as_plan(plan: Union[None, str, SolvePlan]) -> SolvePlan:
    if plan is None or plan == "auto":
        return SolvePlan(mode="auto")
    if isinstance(plan, str):
        if plan not in ("vmap", "sequential"):
            raise ValueError(f"plan must be 'auto'/'vmap'/'sequential' or a SolvePlan; "
                             f"got {plan!r}")
        return SolvePlan(mode=plan)
    if not isinstance(plan, SolvePlan) or plan.mode not in ("auto", "vmap", "sequential"):
        raise ValueError(f"plan must be 'auto'/'vmap'/'sequential' or a SolvePlan; "
                         f"got {plan!r}")
    return plan


def _group_mode(data, member_cfgs: Sequence[FWConfig], plan: SolvePlan) -> str:
    """The plan's mode, or the planner's pick for ``plan.mode == "auto"``."""
    if plan.mode != "auto":
        return plan.mode
    from repro_torch.core.solvers.planner import data_stats, group_mode
    pair = data.pair if hasattr(data, "pair") else data
    return group_mode(data_stats(pair), len(member_cfgs), loss=member_cfgs[0].loss,
                      backend=member_cfgs[0].backend,
                      platform=platform_of(member_cfgs[0].device))


def _run_torch_sparse_group(data, y, member_cfgs: Sequence[FWConfig],
                            plan: SolvePlan) -> List[FWResult]:
    """Dispatch one ``torch_sparse`` sweep group per the plan."""
    if plan.chunk_steps is None and hasattr(data, "tuning_for"):
        # the store's tuned chunk length is the plan's default
        rec = data.tuning_for("torch_sparse", member_cfgs[0].loss)
        if rec is not None and rec.chunk_steps is not None:
            plan = dataclasses.replace(plan, chunk_steps=rec.chunk_steps)
    if plan.chunk_steps is not None:
        # a default, not an override: a config's pin (a group field) wins
        member_cfgs = [c if c.chunk_steps is not None
                       else dataclasses.replace(c, chunk_steps=plan.chunk_steps)
                       for c in member_cfgs]
    if member_cfgs[0].screen_every > 0:
        # once a round fires each config's pair is its own: no lanes
        with obs.span("group.screened", size=len(member_cfgs)):
            return _solve_sequential(data, y, member_cfgs)
    mode = _group_mode(data, member_cfgs, plan)
    if mode == "sequential":
        with obs.span("group.sequential", size=len(member_cfgs)):
            return _solve_sequential(data, y, member_cfgs)
    cohort = any(c.early_stopping for c in member_cfgs)
    with obs.span("group.cohort" if cohort else "group.vmap", size=len(member_cfgs)):
        return _solve_lanes(data, y, member_cfgs)


# ---------------------------------------------------------------------------
# λ-path groups: sequential in λ, lanes across configs
# ---------------------------------------------------------------------------


def _solve_path_sequential(data, y, configs: Sequence[FWConfig]) -> list:
    """One path driver per config over the group's one setup."""
    from repro_torch.core.solvers.path import torch_sparse_path
    g = _group_context(data, y, configs)
    return [torch_sparse_path(g.pcsr, g.pcsc, y, cfg, setup=g.setup) for cfg in configs]


def _solve_path_lanes(data, y, configs: Sequence[FWConfig]) -> list:
    """The group's paths as lanes.  Every lane runs through the same fixed
    global step slots (segment k holds [S_{k-1}, S_k) whether or not its
    certificate landed early; a done lane is frozen, bit for bit), so one
    lane launch of each kernel serves the whole group per step and each
    lane equals its own path driver bit for bit.  ``lambdas`` and ``steps``
    are group fields, so the budgets are shared; ε (hence the EM scale),
    the seed and ``gap_tol`` are per lane."""
    from repro_torch.core.solvers.path import PathResult, path_em_scale, path_plan
    from repro_torch.core.solvers.stopping import resolve_chunk
    from repro_torch.core.solvers.torch_sparse import fw_carry_init_lanes
    from repro_torch.kernels.coord_update.ops import coord_update_scratch, lane_scalars
    c0 = configs[0]
    g = _group_context(data, y, configs)
    stats = _group_stats(g)
    n_cfg = len(configs)
    n, d = g.pcsr.shape
    dev = g.pcsr.device
    plans = [path_plan(c, private=g.private) for c in configs]
    plan0 = plans[0]
    em_scales = [path_em_scale(c, p, n) for c, p in zip(configs, plans)]
    cur = fw_carry_init_lanes(d, g.pcsr.values.dtype, *g.setup, em_scales, g.keys,
                              private=g.private)
    scratch = coord_update_scratch(n, d, dev, lanes=n_cfg) if dev.type == "cuda" else None
    per_cfg: List[list] = [[] for _ in configs]
    for k, lam_k in enumerate(plan0.lambdas):
        budget, seg_off = plan0.budgets[k], plan0.offsets[k]
        if k:   # warm restart per lane: un-freeze the stop flags, keep the rest
            cur.done.fill_(False)
            cur.stop_at.zero_()
        scalars = lane_scalars([lam_k] * n_cfg, em_scales, [c.gap_tol for c in configs], dev)
        chunk = resolve_chunk(dataclasses.replace(c0, steps=budget))
        gaps_buf = torch.zeros((n_cfg, budget), dtype=torch.float32, device=dev)
        coords_buf = torch.full((n_cfg, budget), -1, dtype=torch.int32, device=dev)
        t0 = 0
        while t0 < budget:
            c = min(chunk, budget - t0)
            cur, dones, _ = _lane_chunk(g, stats, c0, cur, scalars, seg_off + t0, c,
                                        (gaps_buf, coords_buf), range(n_cfg), t0,
                                        early_stop=True, scratch=scratch)
            t0 += c
            if all(dones):
                break   # the rest stays sentinels, as the path driver pads them
        dones, stops = cur.done.tolist(), cur.stop_at.tolist()
        for i in range(n_cfg):
            per_cfg[i].append(FWResult(
                w=cur.w[i] * cur.w_m[i], gaps=gaps_buf[i], coords=coords_buf[i],
                losses=torch.zeros(budget, dtype=torch.float32, device=dev),
                stop_step=stops[i] - seg_off if dones[i] else budget,
                stop_reason=STOP_GAP_TOL if dones[i] else STOP_MAX_STEPS))
        if obs.enabled():
            obs.event("path.lambda", index=k, lam=float(lam_k), budget=budget, offset=seg_off,
                      lanes=n_cfg, converged=int(sum(dones)))
    return [PathResult(plans[i].lambdas, per_cfg[i], plans[i]) for i in range(n_cfg)]


def _run_path_group(backend, data, y, member_cfgs: Sequence[FWConfig], plan: SolvePlan) -> list:
    """One λ-path group: lanes or one driver per config for ``torch_sparse``
    groups of two or more, as the plan or the planner says; ``run_path`` per
    config otherwise."""
    if backend.name == "torch_sparse" and len(member_cfgs) > 1:
        if _group_mode(data, member_cfgs, plan) == "vmap":
            with obs.span("group.path", size=len(member_cfgs), mode="fused"):
                return _solve_path_lanes(data, y, member_cfgs)
        with obs.span("group.path", size=len(member_cfgs), mode="sequential"):
            return _solve_path_sequential(data, y, member_cfgs)
    from repro_torch.core.solvers.path import run_path
    with obs.span("group.path", size=len(member_cfgs), mode="sequential"):
        return [run_path(backend, data, y, cfg) for cfg in member_cfgs]


def solve_many(X, y=None, configs: Sequence[FWConfig] = (), *,
               prepared: Optional[Dict[tuple, object]] = None,
               plan: Union[None, str, SolvePlan] = None) -> list:
    """Solve many FW problems over one (X, y); results in input order.

    ``X`` may be anything ``solve`` takes, a ``DatasetStore``/``DatasetRef``
    included (its labels then stand in for ``y``).  Configs are grouped by
    ``GROUP_FIELDS`` after backend (``"auto"`` through the planner) and
    queue resolution; a ``torch_sparse`` group of two or more runs on one
    shared coercion and setup, as lanes or sequentially per the plan:
    ``plan=None``/``"auto"`` asks the planner, ``"vmap"``/``"sequential"``
    or a ``SolvePlan`` override it.  Other groups go through the per-config
    adapter on the shared coercion.  Results equal the configs' own
    ``solve`` runs under every plan.

    ``prepared``: an optional caller-owned ``{(data layout, device): coerced
    X}`` cache; pass the same dict across calls and each layout is coerced
    once.  A config with ``lambdas`` gives a ``PathResult`` at its position.
    """
    configs = list(configs)
    if not configs:
        return []
    with obs.span("solve_many", configs=len(configs)) as sp:
        plan = _as_plan(plan)
        resolved = []
        for c in configs:          # refuse before any compute
            check_supported(c)
            check_gap_certificate(c)
            check_device(c.device)
            if c.screen_every:
                from repro_torch.core.solvers.screening import check_screen_config
                check_screen_config(c)
            if c.lambdas is not None:
                from repro_torch.core.solvers.path import check_path_config
                check_path_config(c)
        X, y = resolve_data(X, y)
        auto_stats = None             # derived once, only if a config asks
        for c in configs:
            if c.backend == "auto":
                from repro_torch.core.solvers.planner import choose_backend, data_stats
                with obs.span("solve.plan"):
                    if auto_stats is None:
                        auto_stats = data_stats(X)
                    c = dataclasses.replace(c, backend=choose_backend(auto_stats, c))
            backend = get_backend(c.backend)
            check_screening_support(backend, c)
            check_path_support(backend, c)
            resolved.append((backend, resolve_queue(backend,
                                                    dataclasses.replace(c, backend=backend.name))))

        if prepared is None:
            prepared = {}                     # (layout, device) -> coerced X
        labels: Dict[str, torch.Tensor] = {}
        for backend, cfg in resolved:
            key = (backend.data_format, str(torch.device(cfg.device)))
            if key not in prepared:
                with obs.span("solve_many.coerce", layout=backend.data_format):
                    prepared[key] = backend.prepare(X, cfg.device)
            if key[1] not in labels:
                labels[key[1]] = labels_on(y, torch.device(cfg.device))

        groups: Dict[Tuple, List[int]] = {}
        for i, (_, cfg) in enumerate(resolved):
            groups.setdefault(group_key(cfg), []).append(i)
        sp.set(groups=len(groups))

        results: List[Optional[FWResult]] = [None] * len(configs)
        for members in groups.values():
            backend, c0 = resolved[members[0]]
            device = str(torch.device(c0.device))
            data = prepared[(backend.data_format, device)]
            y_dev = labels[device]
            member_cfgs = [resolved[i][1] for i in members]
            with obs.span("solve_many.group", backend=backend.name, size=len(members)):
                if c0.lambdas is not None:
                    out = _run_path_group(backend, data, y_dev, member_cfgs, plan)
                elif backend.name == "torch_sparse" and len(members) > 1:
                    out = _run_torch_sparse_group(data, y_dev, member_cfgs, plan)
                elif backend.name == "jax_shard" and len(members) > 1:
                    from repro_torch.core.solvers.jax_shard import solve_shard_group
                    out = solve_shard_group(data, y_dev, member_cfgs)
                else:
                    out = [backend.fn(data, y_dev, cfg) for cfg in member_cfgs]
            for i, res in zip(members, out):
                results[i] = res
    return results  # type: ignore[return-value]
