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

``two_level_draw_lanes`` is the lane form (the JAX package's vmap over a
sweep group): B configs in one launch, each with its own rows of ``c``
(B, G), ``v`` (B, G, M), ``touched`` (B, G), ``out`` and ``done`` (B,), its
own arrival counter, and its key in row b of a (B, 2) device table
(``key_table``).  Lane b draws exactly what ``two_level_draw`` draws from
lane b's state and key.  It counts ``two_level_draw_lanes.launches`` and,
for the rebuild-only form (``rebuild_touched`` on stacked state),
``two_level_draw_lanes.rebuilds``; its plain version loops the single-lane
plain version over the lanes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.samplers.two_level import rebuild_groups_
from repro_torch.kernels import _lib
from repro_torch.kernels.bsls_draw.ref import two_level_draw_lanes_ref, two_level_draw_ref

_ARRIVALS: Dict[int, torch.Tensor] = {}


def arrival_counter(device, lanes: int = 1) -> torch.Tensor:
    """The kernel's (lanes,) int32 arrival counters on ``device``, one per
    lane: each is 0 between launches."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _ARRIVALS or _ARRIVALS[index].numel() < lanes:
        # the old counters are all 0 between launches: a larger zeroed table
        # replaces them
        _ARRIVALS[index] = torch.zeros(max(lanes, 1), dtype=torch.int32,
                                       device=f"cuda:{index}")
    return _ARRIVALS[index][:lanes]


def key_table(keys: Sequence[Sequence[Tuple[int, int]]], device) -> torch.Tensor:
    """(steps, B, 2) int32 table of uint32 key words on ``device`` from
    ``keys[b][i] = (k0, k1)``, lane b's selection key of step i (one upload
    per chunk; row i is step i's (B, 2) table)."""
    arr = np.asarray(keys, dtype=np.uint32).reshape(len(keys), -1, 2).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)


def _check(c, v, touched, done, out, lanes: int) -> None:
    lead = (lanes,) if lanes > 1 or v.dim() == 3 else ()
    if v.dim() != len(lead) + 2:
        raise ValueError(f"two_level_draw: v must be {'(B, G, M)' if lead else '(G, M)'}")
    groups = v.shape[-2]
    if c.dtype != torch.float32 or v.dtype != torch.float32 or c.shape != lead + (groups,):
        raise ValueError("two_level_draw: c (G,) and v (G, M) must be float32 (with a "
                         "leading lane axis B for the lane form)")
    if touched is not None and (touched.dtype != torch.int32 or
                                touched.shape != lead + (groups,)):
        raise ValueError("two_level_draw: touched must be int32 of shape (G,) or (B, G)")
    if done is not None and (done.dtype != torch.bool or done.numel() != lanes):
        raise ValueError("two_level_draw: done must be a bool tensor, one flag per lane")
    if out is not None and (out.dtype != torch.int32 or out.numel() != lanes):
        raise ValueError("two_level_draw: out must be int32, one entry per lane")


def _launch(c, v, touched, key, keys, out, done, draw: bool, lanes: int) -> None:
    _check(c, v, touched, done, out, lanes)
    if keys is not None and (keys.dtype != torch.int32 or keys.shape != (lanes, 2)):
        raise ValueError("two_level_draw: keys must be an int32 (B, 2) table")
    _lib.require_cuda("two_level_draw", c, v, touched, out, done, keys)
    k0, k1 = (int(k) for k in key) if key is not None else (0, 0)
    p = _lib.ptr
    code = _lib.library().port_two_level_draw(
        p(c), p(v), v.shape[-2], v.shape[-1], p(touched), k0, k1, p(keys), p(out), p(done),
        p(arrival_counter(v.device, lanes)), int(draw), lanes, _lib.stream())
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
    _launch(c, v, touched, key, None, out, done, draw=True, lanes=1)
    two_level_draw.launches += 1
    return out


def two_level_draw_lanes(c: torch.Tensor, v: torch.Tensor, keys: torch.Tensor,
                         out: torch.Tensor, done: Optional[torch.Tensor] = None,
                         touched: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B draws in one launch: lane b rebuilds its touched groups and draws
    from ``c[b]``, ``v[b]`` with key ``keys[b]`` ((B, 2) int32 uint32 words)
    into ``out[b]``; a lane whose ``done[b]`` is set writes -1."""
    lanes = v.shape[0]
    if v.device.type == "cpu":
        _check(c, v, touched, done, out, lanes)
        out.copy_(two_level_draw_lanes_ref(c, v, keys, done, touched))
        return out
    _launch(c, v, touched, None, keys, out, done, draw=True, lanes=lanes)
    two_level_draw_lanes.launches += 1
    return out


def rebuild_touched(c: torch.Tensor, v: torch.Tensor, touched: torch.Tensor) -> None:
    """In place: rebuild the touched groups' ``c`` and clear their flags;
    stacked (B, G, M) state rebuilds every lane in one launch."""
    stacked = v.dim() == 3
    if v.device.type == "cpu":
        for b in range(v.shape[0]) if stacked else ():
            rebuild_groups_(c[b], v[b], touched[b])
        if not stacked:
            rebuild_groups_(c, v, touched)
        return
    _launch(c, v, touched, None, None, None, None, draw=False,
            lanes=v.shape[0] if stacked else 1)
    if stacked:
        two_level_draw_lanes.rebuilds += 1
    else:
        two_level_draw.rebuilds += 1


def launch_floor() -> None:
    """Launch an empty kernel (the device time of a launch that does nothing)."""
    _lib.check(_lib.library().port_launch_floor(_lib.stream()), "launch_floor")


two_level_draw.launches = 0
two_level_draw.rebuilds = 0
two_level_draw_lanes.launches = 0
two_level_draw_lanes.rebuilds = 0
