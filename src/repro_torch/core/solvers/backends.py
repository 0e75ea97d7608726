"""The port's registered backends (``repro.core.solvers.backends`` counterpart).

  dense         Alg 1 — dense-work FW (``repro_torch.core.fw_dense``).  Takes a
                dense (N, D) tensor or a padded pair, whose products go through
                the ``ell_matvec`` / ``ell_rmatvec`` kernels.
  torch_sparse  Alg 2 through the port's CUDA kernels (spmv / coord_update /
                bsls_draw), or their plain PyTorch versions on the CPU.  The
                JAX package's name ``jax_sparse`` selects it too.

Each adapter maps its engine onto the shared ``(data, y, FWConfig) ->
FWResult`` contract; ``gap_tol``/``max_seconds`` route to the chunked
early-stopping loop (``stopping.drive_chunks``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.solvers.config import STOP_GAP_TOL, STOP_MAX_STEPS, FWConfig, FWResult
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
          default_queue=None)
def _dense_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.fw_dense import dense_fw, dense_fw_screened, dense_fw_stopping
    if config.queue is not None:  # queue name chosen → translate to selection
        config = dataclasses.replace(config, selection=config.queue, queue=None)
    if config.screen_every > 0:
        return dense_fw_screened(data, y, config)
    if config.early_stopping:
        return dense_fw_stopping(data, y, config)
    return _normalize_stop(dense_fw(data, y, config), config)


@register("torch_sparse", data_format="padded", queues=QUEUE_ALIASES["device"],
          default_queue="group_argmax")
def _torch_sparse_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.solvers.torch_sparse import torch_sparse_fw
    pcsr, pcsc = data
    return torch_sparse_fw(pcsr, pcsc, y, config)
