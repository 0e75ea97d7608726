"""The port's registered backend (``repro.core.solvers.backends`` counterpart).

  torch_sparse  Alg 2 through the port's CUDA kernels (spmv / coord_update /
                bsls_draw), or their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

from repro_torch.core.solvers.config import FWConfig, FWResult
from repro_torch.core.solvers.registry import QUEUE_ALIASES, register


@register("torch_sparse", queues=QUEUE_ALIASES["device"], default_queue="group_argmax")
def _torch_sparse_backend(data, y, config: FWConfig) -> FWResult:
    from repro_torch.core.solvers.torch_sparse import torch_sparse_fw
    pcsr, pcsc = data
    return torch_sparse_fw(pcsr, pcsc, y, config)
