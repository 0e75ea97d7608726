"""``jax_shard`` backend: Algorithm 2 over an (a × b) rank grid
(``repro.core.solvers.jax_shard``).

The registered face of ``repro_torch.distributed``: a config whose
``mesh=(a, b)`` names the grid (row shards × feature shards) runs the
collective schedule of ``distributed.fw_shard`` over ``BlockSparse`` blocks
from ``distributed.ingest`` (a store's shards map onto blocks, with the
content-hash-guarded blocks cache).

A solve is SPMD, as ``torch.distributed`` programs are: every rank of a
default process group of a·b ranks calls ``solve`` with the same config and
data, holds block (r // b, r % b), and gets the whole ``FWResult`` (``w``
gathered over the feature shards).  Without a process group only a 1×1
mesh runs (every collective the identity); it reproduces the single-device
engines' coordinates exactly.  Each rank computes on ``config.device``:
``cuda`` (the rank's current card) unless the config says ``cpu``.

The setup (Alg 2 lines 8-14) runs once per solve or sweep group; the T
steps follow under the spans ``shard.setup`` and ``shard.scan``.  A group
of configs runs as lanes on a 1×1 mesh (the JAX package's vmap), and one
config after another on a larger mesh.  ``max_seconds`` is refused, as in
JAX: the run never looks at a clock.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.core.dp.accountant import em_log_weight_scale
from repro_torch.core.solvers.autotune import platform_of
from repro_torch.core.solvers.config import STOP_GAP_TOL, STOP_MAX_STEPS, FWConfig, FWResult
from repro_torch.core.solvers.registry import check_device
from repro_torch.core.solvers.torch_sparse import _sync
from repro_torch.distributed.collectives import ShardMesh, make_mesh
from repro_torch.distributed.fw_shard import rank_labels, shard_scan, shard_setup
from repro_torch.distributed.ingest import ShardSource

PRIVATE_SELECTION = "gumbel"


def mesh_grid(config: FWConfig, src: ShardSource = None) -> Tuple[int, int]:
    """The (a × b) grid of one solve: the config's pin, else the store's
    tuning record for this device's platform, else 1×1."""
    if config.mesh is not None:
        return tuple(int(v) for v in config.mesh)
    store = getattr(src, "store", None)
    if store is not None and hasattr(store, "autotune_load"):
        rec = store.autotune_load("jax_shard", config.loss, platform_of(config.device))
        if rec is not None and rec.mesh is not None:
            return tuple(int(v) for v in rec.mesh)
    return (1, 1)


def _record_shard_cost(src: ShardSource, mode: str, seconds_per_step_lane: float, *,
                       loss: str, device) -> None:
    """Feed the group's timing to the planner under the ``jax_shard`` key."""
    from repro_torch.core.solvers.planner import data_stats, record_cost
    source = src.csr if src.csr is not None else src.store
    if source is None:
        return
    record_cost("jax_shard", mode, platform_of(device), data_stats(source),
                seconds_per_step_lane, loss=loss)


def shard_em_scale(config: FWConfig, n_rows: int) -> float:
    """EM log-weight scale of the ``gumbel`` selection: the
    ``core.dp.accountant`` formula every private engine uses."""
    if config.queue != PRIVATE_SELECTION:
        return 1.0
    return em_log_weight_scale(epsilon=config.epsilon, delta=config.delta, steps=config.steps,
                               n_rows=n_rows, lipschitz=config.loss_fn().lipschitz)


def _pad_labels(y, n_pad: int, device) -> torch.Tensor:
    y = torch.as_tensor(np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y),
                        dtype=torch.float32)
    out = torch.zeros(n_pad, dtype=torch.float32)
    out[:y.shape[0]] = y
    return out.to(device)


def _shard_result(w, gaps, coords, stop_step, steps: int) -> FWResult:
    stop = int(stop_step)
    return FWResult(w=w, gaps=gaps, coords=coords, losses=torch.zeros_like(gaps),
                    stop_step=stop, stop_reason=STOP_GAP_TOL if stop < steps else STOP_MAX_STEPS)


def _reject_max_seconds(config: FWConfig) -> None:
    if config.max_seconds is not None:
        raise ValueError("jax_shard runs its steps without watching a wall clock; use "
                         "gap_tol, or a host backend for max_seconds")


def _run(src: ShardSource, y, configs: Sequence[FWConfig], mesh: ShardMesh, *,
         lanes: bool) -> List[FWResult]:
    """Setup once, then the configs' steps: together as lanes, or one after
    another; records the per-step-lane time under ``jax_shard``."""
    c0 = configs[0]
    dev = check_device(c0.device)
    a, b = mesh.a, mesh.b
    blocks = src.blocks(a, b)
    n, d = src.shape
    blk = src.local(a, b, mesh.ai, mesh.bj, dev)
    y_loc = rank_labels(_pad_labels(y, blocks.padded[0], dev), blocks, mesh)
    early = any(c.gap_tol > 0 for c in configs)
    t0 = time.perf_counter()
    with obs.span("shard.setup", mesh=f"{a}x{b}", size=len(configs)):
        setup = shard_setup(blk, y_loc, n=n, loss=c0.loss, mesh=mesh)
    batches = [list(configs)] if lanes else [[c] for c in configs]
    results = []
    with obs.span("shard.scan", mesh=f"{a}x{b}", steps=c0.steps):
        for batch in batches:
            w, gaps, coords, stops = shard_scan(
                blk, y_loc, setup, lams=[c.lam for c in batch],
                em_scales=[shard_em_scale(c, n) for c in batch],
                gap_tols=[c.gap_tol for c in batch],
                keys=[prng.PRNGKey(c.seed) for c in batch], steps=c0.steps, shape=(n, d),
                loss=c0.loss, selection=c0.queue, early_stop=early, mesh=mesh)
            results += [_shard_result(w[i, :d], gaps[i], coords[i], stops[i], c0.steps)
                        for i in range(len(batch))]
        _sync(dev)
    _record_shard_cost(src, "vmap" if lanes and len(configs) > 1 else "sequential",
                       (time.perf_counter() - t0) / max(c0.steps * len(configs), 1),
                       loss=c0.loss, device=dev)
    return results


def shard_fw(src: ShardSource, y, config: FWConfig) -> FWResult:
    """One solve through the sharded collective schedule."""
    _reject_max_seconds(config)
    mesh = make_mesh(*mesh_grid(config, src))
    return _run(src, y, [config], mesh, lanes=False)[0]


def solve_shard_group(src: ShardSource, y, configs: Sequence[FWConfig]) -> List[FWResult]:
    """A compatible config group on one shared setup: lanes on a 1×1 mesh,
    one config after another otherwise."""
    for c in configs:
        _reject_max_seconds(c)
    mesh = make_mesh(*mesh_grid(configs[0], src))
    return _run(src, y, configs, mesh, lanes=mesh.a * mesh.b == 1)
