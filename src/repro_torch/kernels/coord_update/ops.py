"""``coord_update``: one Frank-Wolfe step for the selected column (Alg 2,
lines 16-29), in place on the run's state.

On CUDA tensors it launches ``csrc/coord_update.cu`` (one specialisation per
objective); on CPU tensors it runs the plain version.  ``j`` is a (1,) int32
device tensor, so the selection never passes through the host.  The step
writes its gap and coordinate into ``gaps[slot]`` / ``coords[slot]``.
``queue`` is the sampler state the step refreshes: a ``TwoLevelSamplerState``
(private; priorities scaled by ``em_scale``, groups marked for
``tl_rebuild_``) or a ``GroupArgmaxState`` (bounds ratcheted).

A masked run passes its ``done`` (bool) and ``stop_at`` (int32) device
flags: a step that finds ``done`` set writes only the sentinels
``gaps[slot] = 0``, ``coords[slot] = -1``; the step whose gap is
``<= gap_tol`` (float32) is applied and sets ``done`` and ``stop_at = t``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.two_level import TwoLevelSamplerState
from repro_torch.kernels import _lib
from repro_torch.kernels.coord_update.ref import coord_update_ref


def coord_update(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, *,
                 t: float, lam: float, inv_n: float, em_scale: float, loss: str,
                 gaps: torch.Tensor, coords: torch.Tensor, slot: int,
                 scratch: Optional[torch.Tensor] = None, done: Optional[torch.Tensor] = None,
                 stop_at: Optional[torch.Tensor] = None, gap_tol: float = 0.0) -> None:
    """``scratch``: float32 (≥ max column nnz,) buffer on CUDA (allocated if None)."""
    obj = get_loss(loss)
    kw = dict(t=t, lam=lam, inv_n=inv_n, em_scale=em_scale, loss=loss,
              gaps=gaps, coords=coords, slot=slot, done=done, stop_at=stop_at,
              gap_tol=gap_tol)
    if alpha.device.type == "cpu":
        coord_update_ref(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, **kw)
        return
    private = isinstance(queue, TwoLevelSamplerState)
    prio = queue.v if private else queue.p
    if not obj.separable and y is None:
        raise ValueError(f"loss {loss!r} is label-coupled; pass y")
    if j.dtype != torch.int32 or coords.dtype != torch.int32:
        raise ValueError("coord_update: j and coords must be int32")
    floats = (w, w_m, g_tilde, vbar, qbar, alpha, prio, gaps, pcsr.values)
    if any(x.dtype != torch.float32 for x in floats) or (
            y is not None and not obj.separable and y.dtype != torch.float32):
        raise ValueError("coord_update: state tensors must be float32")
    if pcsr.indices.dtype != torch.int32 or pcsr.nnz.dtype != torch.int32:
        raise ValueError("coord_update: padded CSR ids must be int32")
    if not 0 <= slot < gaps.shape[0]:
        raise ValueError(f"coord_update: slot {slot} outside the output arrays")
    if (done is None) != (stop_at is None) or (done is not None and (
            done.dtype != torch.bool or stop_at.dtype != torch.int32)):
        raise ValueError("coord_update: pass both done (bool) and stop_at (int32), or neither")
    if scratch is None:
        scratch = torch.empty(pcsr.shape[0], dtype=torch.float32, device=alpha.device)
    y_arg = None if obj.separable else y
    bound = None if private else queue.bound
    touched = queue.touched if private else None
    _lib.require_cuda("coord_update", j, pcsr.indices, pcsr.values, pcsr.nnz, y_arg, w, w_m,
                      g_tilde, vbar, qbar, alpha, prio, bound, touched, gaps, coords, scratch,
                      done, stop_at)
    cols = _lib.col_table(pcsc)
    p = _lib.ptr
    code = _lib.library().port_coord_update(
        obj.kernel_id, p(j), *cols, p(pcsr.indices), p(pcsr.values), p(pcsr.nnz),
        pcsr.indices.shape[1], p(y_arg), p(w), p(w_m), p(g_tilde), p(vbar), p(qbar),
        p(alpha), p(prio), p(bound), p(touched), queue.group_size,
        em_scale if private else 1.0, t, lam, inv_n, alpha.shape[0], p(gaps), p(coords),
        slot, p(scratch), p(done), p(stop_at), gap_tol, _lib.stream())
    _lib.check(code, "coord_update")
    coord_update.launches += 1


coord_update.launches = 0
