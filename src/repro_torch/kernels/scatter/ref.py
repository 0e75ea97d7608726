"""Plain PyTorch version of ``scatter_add_ordered`` (what the CPU runs).

``out = dst`` with ``src[i]`` added at ``idx[i]`` for every live lane, each
target's terms added one at a time **in input order**: ``out[t] = ((dst[t] +
s_a) + s_b) + …`` over the live lanes ``a < b < …`` with ``idx = t``.  That
is the order of the JAX package's ``.at[idx].add(src)`` on the CPU (XLA adds
the updates one by one) and of ``numpy.add.at``.  A dead lane adds nothing.

On the CPU, ``index_add_`` into a 1-D tensor is a serial loop over the lanes
in input order, so it states the order directly.  ``index_put_(accumulate=
True)`` does not: from 32,768 lanes on, with more than one thread, the CPU
adds with atomics in parallel, in no set order (``tests/test_torch_scatter.py``
holds both facts).
"""
from __future__ import annotations

from typing import Optional

import torch


def scatter_add_ordered_ref(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                            live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) ``dst`` plus the live lanes of ``src`` at ``idx``, in input order
    (functional; CPU tensors).  ``idx``, ``src`` and ``live`` share one shape,
    which is read flat; a live lane's index lies in ``[0, n)``."""
    if dst.device.type != "cpu":
        raise ValueError("scatter_add_ordered_ref runs on the CPU; on the card call "
                         "kernels.scatter.scatter_add_ordered")
    idx, src = idx.reshape(-1).long(), src.reshape(-1)
    if live is not None:
        keep = live.reshape(-1)
        idx, src = idx[keep], src[keep]
    return dst.clone().index_add_(0, idx, src.to(dst.dtype))
