"""Plain PyTorch version of the ``coord_update`` kernel: one Frank-Wolfe step
for the selected column j (paper Alg 2, lines 16-29), in place.

Lines 16-21 (scalars, w[j], the step's gap and coordinate), lines 22-28 (the
fused update of ``repro/kernels/coord_update/ref.py``) and the line-29 queue
refresh, over the live lanes of column j and of its rows only — the padded
lanes the JAX package also walks add ±0 and rewrite unchanged priorities.
With the masked run's ``done``/``stop_at`` flags it freezes as the kernel
does (``ops.coord_update``).
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.group_argmax import ga_scatter_
from repro_torch.core.samplers.two_level import TwoLevelSamplerState, tl_scatter_


def coord_update_ref(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, *,
                     t: float, lam: float, inv_n: float, em_scale: float, loss: str,
                     gaps: torch.Tensor, coords: torch.Tensor, slot: int,
                     done=None, stop_at=None, gap_tol: float = 0.0) -> None:
    obj = get_loss(loss)
    dev = alpha.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    if done is not None and bool(done):
        gaps[slot], coords[slot] = 0.0, -1
        return
    jj = min(int(j[0]), alpha.shape[0] - 1)
    # ---- lines 16-21 --------------------------------------------------------
    a_j = alpha[jj]
    lam_t = f32(lam)
    d_tilde = torch.where(a_j == 0, lam_t, -lam_t * torch.sign(a_j))
    gap = g_tilde - d_tilde * a_j
    gaps[slot] = gap
    coords[slot] = jj
    if done is not None and gap_tol > 0 and bool(gap <= f32(gap_tol)):
        done.fill_(True)
        stop_at.fill_(int(t))
    eta = f32(2.0) / (f32(t) + 2.0)
    wm = w_m * (1.0 - eta)
    edt = eta * d_tilde
    w[jj] = w[jj] + edt / wm
    gt = g_tilde * (1.0 - eta) + edt * a_j
    # ---- lines 22-28 over the live lanes of column j ------------------------
    rows, xv = pcsc.col_live(jj)
    rows = rows.long()
    vb = vbar[rows] + edt * xv / wm
    vbar[rows] = vb
    hm = obj.h(wm * vb, None if obj.separable else y[rows])
    q = qbar[rows]
    gamma = hm - q
    qbar[rows] = q + gamma
    gs = gamma * inv_n
    ridx = pcsr.indices[rows].long()                    # (n, Kr)
    rval = pcsr.values[rows]                            # (n, Kr), 0 at padding
    live = torch.arange(ridx.shape[1], device=dev)[None, :] < pcsr.nnz[rows][:, None]
    dots = (rval * w[ridx]).sum(dim=1)
    cols = ridx[live]                                   # row-major: lane order
    alpha.index_add_(0, cols, (gs[:, None] * rval)[live])
    # ---- line 29: refresh the touched coordinates ---------------------------
    fresh = alpha[cols].abs()
    if isinstance(queue, TwoLevelSamplerState):
        tl_scatter_(queue, cols, fresh * em_scale)
    else:
        ga_scatter_(queue, cols, fresh)
    w_m.copy_(wm)
    g_tilde.copy_(gt + wm * (gs * dots).sum())
