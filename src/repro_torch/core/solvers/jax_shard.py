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
steps follow under the spans ``shard.setup`` and ``shard.scan``.

``shard_dry_run`` is the counterpart of the JAX package's ``shard_lowering``
for ``launch/dryrun.py``: rank 0 of a grid alone, on ``distributed``'s
``DryMesh``, recording the collectives it would send.  A group
of configs runs as lanes on a 1×1 mesh (the JAX package's vmap), and one
config after another on a larger mesh.  ``max_seconds`` is refused, as in
JAX: the run never looks at a clock.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.distributed.block_sparse import (BlockAssembler, LocalBlock, _run_ranks,
                                                  block_specs)
from repro_torch.distributed.collectives import Collective, DryMesh, ShardMesh, make_mesh
from repro_torch.distributed.fw_shard import DistFWConfig, rank_labels, shard_scan, shard_setup
from repro_torch.kernels.scatter import scatter_add_ordered
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


@dataclasses.dataclass
class ShardDryRun:
    """What rank 0 of an (a × b) grid ran: its block's shapes and bytes,
    the collectives of the setup, of each step (every step sends the same)
    and of the output's gather, and its in-order scatter launches."""

    block: LocalBlock
    block_bytes: int            # the rank's block and its labels
    setup: List[Collective]
    step: List[Collective]
    steps: int
    output: List[Collective]
    scatter_launches: int

    @property
    def records(self) -> List[Collective]:
        """The collectives of the setup and the steps: what the JAX
        package's whole-run program sends (its output w stays sharded over
        "model", so it has no counterpart of the port's final gather)."""
        return self.setup + self.step * self.steps


def dry_block(n: int, d: int, a: int, b: int, *, kc: int, kr: int, density: float,
              seed: int = 0) -> Tuple[LocalBlock, torch.Tensor]:
    """Rank 0's block of an (N × D) design on an (a × b) grid, and its labels,
    on the host: ``block_specs``' shapes exactly.  A COO of uniform random
    entries at ``density`` (seeded by ``seed``), each column's first ``kc``
    and each row's first ``kr`` entries kept, through ``BlockAssembler``."""
    _, spec = block_specs(n, d, a, b, kc, kr)
    d_loc, n_loc = spec.csc_rows.shape[0], spec.csr_cols.shape[0]
    rng = np.random.default_rng(seed)
    m = int(round(n_loc * d_loc * density))
    key = np.unique(rng.integers(0, n_loc * d_loc, size=m, dtype=np.int64))
    rows, cols = np.divmod(key, d_loc)                  # row-major: rows ascending
    col_order = np.argsort(cols, kind="stable")
    col_rank = np.empty_like(cols)
    col_rank[col_order] = _run_ranks(cols[col_order])
    keep = (col_rank < kc) & (_run_ranks(rows) < kr)
    rows, cols = rows[keep], cols[keep]
    vals = rng.normal(size=rows.size).astype(np.float32)
    asm = BlockAssembler(n_loc, d_loc, 1, 1)
    asm.count(rows, cols)
    asm.alloc(kc, kr)
    asm.fill(rows, cols, vals)
    blk = asm.finish().local(0, 0, "cpu")
    if any(tuple(t.shape) != tuple(u.shape) for t, u in zip(blk, spec)):
        raise AssertionError("dry_block: the block's shapes are not block_specs'")
    y = torch.from_numpy(rng.integers(0, 2, size=n_loc).astype(np.float32))
    return blk, y


def shard_dry_run(n: int, d: int, a: int, b: int, *, steps: int, kc: int, kr: int,
                  density: float, selection: str = PRIVATE_SELECTION, compress_topk: int = 0,
                  loss: str = "logistic", seed: int = 0, device="cuda") -> ShardDryRun:
    """The ``jax_shard`` program of an (N × D) design on an (a × b) grid, run
    by rank 0 alone for ``steps`` steps of one lane on ``device`` (the card
    unless the caller asks for the CPU): ``shard_setup`` and ``shard_scan``
    on a ``DryMesh``, over ``dry_block``'s block.  The counterpart of the JAX
    package's ``shard_lowering``, which lowers this program for the
    compiler: its numbers are one rank's shapes, launches, collective bytes
    and memory, not a solve (the other ranks' blocks do not exist, and each
    collective returns this rank's own part)."""
    dev = check_device(device)
    blk, y = dry_block(n, d, a, b, kc=kc, kr=kr, density=density, seed=seed)
    blk = LocalBlock(*(t.to(dev) for t in blk))
    y = y.to(dev)
    rec: List[Collective] = []
    mesh = DryMesh(a, b, recorder=rec)
    cfg = DistFWConfig(steps=steps, loss=loss, selection=selection, seed=seed,
                       compress_topk=compress_topk)
    launches = scatter_add_ordered.launches
    setup = shard_setup(blk, y, n=n, loss=loss, mesh=mesh)
    n_setup = len(rec)
    shard_scan(blk, y, setup, lams=[cfg.lam], em_scales=[cfg.em_scale(n)], gap_tols=[0.0],
               keys=[prng.PRNGKey(seed)], steps=steps, shape=(n, d), loss=loss,
               selection=selection, compress_topk=compress_topk, mesh=mesh)
    _sync(dev)
    body, output = rec[n_setup:-1], rec[-1:]     # the scan ends with w's gather
    per = len(body) // max(steps, 1)
    step = body[:per]
    if len(body) != per * steps or any(body[i * per:(i + 1) * per] != step
                                       for i in range(steps)):
        raise AssertionError("shard_dry_run: the steps sent different collectives")
    nbytes = sum(t.numel() * t.element_size() for t in (*blk, y))
    return ShardDryRun(block=blk, block_bytes=nbytes, setup=rec[:n_setup],
                       step=step, steps=steps, output=output,
                       scatter_launches=scatter_add_ordered.launches - launches)
