"""``two_level_draw``: rebuild the touched groups, then one exponential-mechanism
draw j ~ softmax(v.flatten()).

On CUDA tensors it launches ``csrc/two_level_draw.cu`` (one block per group
rebuilds the touched groups' log-sum-exps ``c`` in place and clears their
flags; the last block to arrive draws, big step and little step, noise from
the key in the kernel); on CPU tensors it runs the plain version.  ``key``
is a (k0, k1) pair of uint32 values — the step's selection key of the JAX
key chain.  In a masked run, a draw that finds the device flag ``done``
(bool) set rebuilds, then writes the sentinel -1 and draws nothing.
``rebuild_touched`` is the same kernel without the draw; it counts its
launches in ``two_level_draw.rebuilds``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.samplers.two_level import rebuild_groups_
from repro_torch.kernels import _lib
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref

_ARRIVALS: Dict[int, torch.Tensor] = {}


def arrival_counter(device) -> torch.Tensor:
    """The kernel's (1,) int32 arrival counter on ``device``: 0 between launches."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _ARRIVALS:
        _ARRIVALS[index] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
    return _ARRIVALS[index]


def _launch(c, v, touched, key, out, done, draw: bool) -> None:
    groups, group_size = v.shape
    if c.dtype != torch.float32 or v.dtype != torch.float32 or c.shape != (groups,):
        raise ValueError("two_level_draw: c (G,) and v (G, M) must be float32")
    if touched is not None and (touched.dtype != torch.int32 or touched.shape != (groups,)):
        raise ValueError("two_level_draw: touched must be int32 of shape (G,)")
    if done is not None and done.dtype != torch.bool:
        raise ValueError("two_level_draw: done must be a bool tensor")
    if out is not None and out.dtype != torch.int32:
        raise ValueError("two_level_draw: out must be int32")
    _lib.require_cuda("two_level_draw", c, v, touched, out, done)
    k0, k1 = (int(k) for k in key) if key is not None else (0, 0)
    p = _lib.ptr
    code = _lib.library().port_two_level_draw(
        p(c), p(v), groups, group_size, p(touched), k0, k1, p(out), p(done),
        p(arrival_counter(v.device)), int(draw), _lib.stream())
    _lib.check(code, "two_level_draw")


def two_level_draw(c: torch.Tensor, v: torch.Tensor, key,
                   out: Optional[torch.Tensor] = None,
                   done: Optional[torch.Tensor] = None,
                   touched: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the draw's flat index into ``out`` ((1,) int32, allocated if None).

    ``touched``: the queue's (G,) int32 flags; the groups it marks get their
    ``c`` rebuilt (in place) and their flag cleared before the draw.
    """
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=v.device)
    if v.device.type == "cpu":
        out.copy_(two_level_draw_ref(c, v, key, done, touched))
        return out
    _launch(c, v, touched, key, out, done, draw=True)
    two_level_draw.launches += 1
    return out


def rebuild_touched(c: torch.Tensor, v: torch.Tensor, touched: torch.Tensor) -> None:
    """In place: rebuild the touched groups' ``c`` and clear their flags."""
    if v.device.type == "cpu":
        rebuild_groups_(c, v, touched)
        return
    _launch(c, v, touched, None, None, None, draw=False)
    two_level_draw.rebuilds += 1


def launch_floor() -> None:
    """Launch an empty kernel (the device time of a launch that does nothing)."""
    _lib.check(_lib.library().port_launch_floor(_lib.stream()), "launch_floor")


two_level_draw.launches = 0
two_level_draw.rebuilds = 0
