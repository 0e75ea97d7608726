"""``two_level_draw``: one exponential-mechanism draw j ~ softmax(v.flatten()).

On CUDA tensors it launches ``csrc/two_level_draw.cu`` (big step and little
step in one block, noise from the key in the kernel); on CPU tensors it runs
the plain version.  ``key`` is a (k0, k1) pair of uint32 values — the step's
selection key of the JAX key chain.  In a masked run, a draw that finds the
device flag ``done`` (bool) set writes the sentinel -1 and draws nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref


def two_level_draw(c: torch.Tensor, v: torch.Tensor, key,
                   out: Optional[torch.Tensor] = None,
                   done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the draw's flat index into ``out`` ((1,) int32, allocated if None)."""
    groups, group_size = v.shape
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=v.device)
    if v.device.type == "cpu":
        out.copy_(two_level_draw_ref(c, v, key, done))
        return out
    if done is not None and done.dtype != torch.bool:
        raise ValueError("two_level_draw: done must be a bool tensor")
    if c.dtype != torch.float32 or v.dtype != torch.float32 or c.shape != (groups,):
        raise ValueError("two_level_draw: c (G,) and v (G, M) must be float32")
    if out.dtype != torch.int32:
        raise ValueError("two_level_draw: out must be int32")
    _lib.require_cuda("two_level_draw", c, v, out, done)
    k0, k1 = (int(k) for k in key)
    code = _lib.library().port_two_level_draw(
        _lib.ptr(c), _lib.ptr(v), groups, group_size, k0, k1, _lib.ptr(out), _lib.ptr(done),
        _lib.stream())
    _lib.check(code, "two_level_draw")
    two_level_draw.launches += 1
    return out


two_level_draw.launches = 0
