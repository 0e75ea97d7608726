"""``scatter_add_ordered``: a scatter-add whose sums are the CPU's on the card.

``out = dst`` with ``src[i]`` added at ``idx[i]`` for every live lane, each
target's terms in input order (``ref.py``).  On a CUDA tensor the wrapper
checks its arguments, allocates ``out`` and one scratch buffer sized from the
shapes, and launches ``csrc/scatter_add_ordered.cu``: a pass over the live
flags that compacts the live lanes in input order (a dead lane costs its
flag's byte), a hand-written stable grouping of the live lanes by target
(one block in shared memory when they number at most 8,192, else 8-bit
digit passes over the card), and one chain of in-order adds a touched
target.  The route is chosen on the card: the wrapper runs no torch op over
the lanes and never reads the device.  On a CPU tensor it runs the plain
version.  There is no fallback from one to the other.
``scatter_add_ordered.launches`` counts the wrapper's calls on the card (one
a call, whatever the number of kernels the call launches).
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
    if k == 0 or n == 0:
        return dst.clone()
    dst, idx, src = dst.contiguous(), idx.reshape(-1), src.reshape(-1)
    live = None if live is None else live.reshape(-1)
    lib = _lib.library()
    out = torch.empty_like(dst, memory_format=torch.contiguous_format)
    scratch = torch.empty(lib.port_scatter_scratch_words(k), dtype=torch.int32,
                          device=dst.device)
    _lib.require_cuda("scatter_add_ordered", dst, idx, src, live, out, scratch)
    code = lib.port_scatter_add_ordered(
        _lib.ptr(dst), _lib.ptr(out), n, _lib.ptr(idx), int(idx.dtype == torch.int64),
        _lib.ptr(src), _lib.ptr(live), k, _lib.ptr(scratch), _lib.stream())
    _lib.check(code, "scatter_add_ordered")
    scatter_add_ordered.launches += 1
    return out


scatter_add_ordered.launches = 0
