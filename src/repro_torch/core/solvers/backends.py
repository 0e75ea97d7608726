"""The port's registered backends (``repro.core.solvers.backends`` counterpart).

  dense         Alg 1 — dense-work FW (``repro_torch.core.fw_dense``).  Takes a
                dense (N, D) tensor or a padded pair, whose products go through
                the ``ell_matvec`` / ``ell_rmatvec`` kernels.
  torch_dense   Alg 2's state machine with dense vector updates in plain torch
                ops (``repro_torch.core.fw_torch``, the JAX ``jax_dense``,
                whose name selects it too); its setup runs ``ell_rmatvec``.
  host_sparse   Alg 2, the faithful float64 host loop with the exact FLOP
                audit and the paper's queues (``repro_torch.core.fw_sparse``).
  torch_sparse  Alg 2 through the port's CUDA kernels (spmv / coord_update /
                bsls_draw), or their plain PyTorch versions on the CPU.  The
                JAX package's name ``jax_sparse`` selects it too.
  jax_shard     Alg 2 over an (a × b) grid of ranks (``FWConfig.mesh``):
                the collective schedule of ``repro_torch.distributed`` over
                ``BlockSparse`` blocks, its scatters through the in-order
                scatter kernel; a 1×1 mesh takes the single-device engines'
                coordinates.

Each adapter maps its engine onto the shared ``(data, y, FWConfig) ->
FWResult`` contract; on ``dense`` and ``torch_sparse``,
``gap_tol``/``max_seconds`` route to the chunked early-stopping loop
(``stopping.drive_chunks``) and ``screen_every`` to its screened form
(``screening``); those two support screening and λ-paths (``path``).
``torch_dense`` masks ``gap_tol`` inside its one loop and refuses
``max_seconds``; ``host_sparse`` stops on either in its host loop.  Both
refuse screening and paths, as in the JAX package.  A dataset store reaches
the padded backends as a ``PreparedDataset``, whose cached setup state is
replayed; for ``torch_sparse`` its tuning record, when one exists for the
device's platform, picks the tiered CSC and the chunk length.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.solvers.config import STOP_GAP_TOL, STOP_MAX_STEPS, FWConfig, FWResult
from repro_torch.core.solvers.prepared import PreparedDataset
from repro_torch.core.solvers.registry import QUEUE_ALIASES, register


def _normalize_stop(res: FWResult, config: FWConfig) -> FWResult:
    """Make ``stop_step`` an int and name the stop: a masked run that ended
    before T stopped on the gap certificate."""
    stop = res.stop_step_or(config.steps)
    res.stop_step = stop
    if stop < config.steps and res.stop_reason == STOP_MAX_STEPS:
        res.stop_reason = STOP_GAP_TOL
    return res


@register("dense", data_format="dense", queues=QUEUE_ALIASES["selection"],
          default_queue=None, supports_screening=True, supports_path=True)
def _dense_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.fw_dense import dense_fw, dense_fw_screened, dense_fw_stopping
    if config.queue is not None:  # queue name chosen → translate to selection
        config = dataclasses.replace(config, selection=config.queue, queue=None)
    if config.screen_every > 0:
        return dense_fw_screened(data, y, config)
    if config.early_stopping:
        return dense_fw_stopping(data, y, config)
    return _normalize_stop(dense_fw(data, y, config), config)


def torch_sparse_operands(data, y, config: FWConfig):
    """(pcsr, pcsc, setup, config) of a ``torch_sparse`` solve on ``data``.

    A dataset store (a ``PreparedDataset``) replays its cached setup state
    and applies its tuning record for the device's platform, when one
    exists: the tiered CSC and, unless the config pins one, the chunk length
    — parity-gated at tuning time, so the iterates are the same.  A padded
    pair has no setup yet (None)."""
    if not isinstance(data, PreparedDataset):
        pcsr, pcsc = data
        return pcsr, pcsc, None, config
    setup = data.setup_for(y, config.loss)
    pcsr, pcsc = data.pair
    rec = data.tuning_for("torch_sparse", config.loss)
    if rec is not None:
        if rec.ell_width is not None:
            pcsc = data.tuned_pcsc(rec)
        if config.chunk_steps is None and rec.chunk_steps is not None:
            config = dataclasses.replace(config, chunk_steps=rec.chunk_steps)
    return pcsr, pcsc, setup, config


@register("torch_sparse", data_format="padded", queues=QUEUE_ALIASES["device"],
          default_queue="group_argmax", supports_screening=True, supports_path=True)
def _torch_sparse_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.solvers.torch_sparse import torch_sparse_fw
    pcsr, pcsc, setup, config = torch_sparse_operands(data, y, config)
    return torch_sparse_fw(pcsr, pcsc, y, config, setup=setup)


@register("torch_dense", data_format="padded", queues=QUEUE_ALIASES["device"],
          default_queue="group_argmax", supports_max_seconds=False)
def _torch_dense_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.fw_torch import sparse_fw_torch
    if config.max_seconds is not None:
        raise ValueError(
            "torch_dense runs as one compiled scan and cannot watch a wall "
            "clock; use gap_tol, or the dense/host_sparse/torch_sparse backends "
            "for max_seconds")
    setup = None
    if isinstance(data, PreparedDataset):   # the store's cached setup state
        setup = data.setup_for(y, config.loss)
        data = data.pair
    pcsr, pcsc = data
    return _normalize_stop(sparse_fw_torch(pcsr, pcsc, y, config, setup=setup), config)


@register("jax_shard", data_format="blocks", queues=QUEUE_ALIASES["shard"],
          default_queue="argmax", supports_max_seconds=False)
def _jax_shard_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.solvers.jax_shard import shard_fw
    return shard_fw(data, y, config)


@register("host_sparse", data_format="host", queues=QUEUE_ALIASES["host"],
          default_queue="fib_heap")
def _host_sparse_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.fw_sparse import sparse_fw
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
    res = sparse_fw(
        data, np.asarray(y, np.float64), lam=config.lam, steps=config.steps,
        loss=config.loss, queue=config.queue, epsilon=config.epsilon,
        delta=config.delta, seed=config.seed, gap_tol=config.gap_tol,
        max_seconds=config.max_seconds)
    on = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype, device=config.device)
    gaps = on(res.gaps, torch.float32)
    return FWResult(w=on(res.w, torch.float32), gaps=gaps, coords=on(res.coords, torch.int32),
                    losses=torch.zeros_like(gaps),
                    stop_step=res.stop_step if res.stop_step is not None else config.steps,
                    stop_reason=res.stop_reason)
