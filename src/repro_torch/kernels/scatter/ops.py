"""``scatter_add_ordered``: a scatter-add whose sums are the CPU's on the card.

``out = dst`` with ``src[i]`` added at ``idx[i]`` for every live lane, each
target's terms in input order (``ref.py``).  On a CUDA tensor it groups the
lanes by target with a stable ``torch.sort`` of the keys (a dead lane keyed
past every target) and launches ``csrc/scatter_add_ordered.cu``, which adds
each target's run as one chain onto ``dst``; on a CPU tensor it runs the
plain version.  There is no fallback from one to the other.
``scatter_add_ordered.launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.scatter.ref import scatter_add_ordered_ref


def scatter_add_ordered(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                        live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) ``dst`` plus the live lanes of ``src`` at ``idx`` (functional);
    ``idx``, ``src`` and ``live`` (bool, None for all lanes) share one shape."""
    if dst.device.type == "cpu":
        return scatter_add_ordered_ref(dst, idx, src, live)
    n, k = dst.numel(), idx.numel()
    if dst.dim() != 1 or dst.dtype != torch.float32 or src.dtype != torch.float32:
        raise ValueError("scatter_add_ordered: dst must be a 1-D float32 tensor and src float32")
    if src.numel() != k or (live is not None and (live.numel() != k or live.dtype != torch.bool)):
        raise ValueError("scatter_add_ordered: idx, src and live must have one shape "
                         "(live bool)")
    if idx.dtype not in (torch.int32, torch.int64) or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError("scatter_add_ordered: integer indices, fewer than 2^31 targets and lanes")
    out = dst.clone()
    if k == 0 or n == 0:
        return out
    keys = idx.reshape(-1).to(torch.int32)
    if live is not None:
        keys = torch.where(live.reshape(-1), keys, n)
    keys, perm = torch.sort(keys, stable=True)
    terms = src.reshape(-1).contiguous()
    bounds = torch.empty(2 * n, dtype=torch.int32, device=dst.device)
    _lib.require_cuda("scatter_add_ordered", keys, perm, terms, out, bounds)
    code = _lib.library().port_scatter_add_ordered(
        _lib.ptr(keys), _lib.ptr(perm), _lib.ptr(terms), k, _lib.ptr(out), n, _lib.ptr(bounds),
        _lib.stream())
    _lib.check(code, "scatter_add_ordered")
    scatter_add_ordered.launches += 1
    return out


scatter_add_ordered.launches = 0
