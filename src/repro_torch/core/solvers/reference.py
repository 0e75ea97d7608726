"""Straight-line oracle of the ``torch_sparse`` schedule
(``repro.core.solvers.reference``).

``reference_fw`` replays ``torch_sparse.fw_scan``'s state machine eagerly in
plain torch ops on any device: no kernel, no incremental sampler state.
The selection priorities are recomputed from |α| every step, and the DP draw
re-realizes ``kernels/bsls_draw``'s ``two_level_draw`` — group then member
Gumbel-max, noise of shapes (G,) and (1, M) from the same key stream (one
``key, sel_key = split(key)`` a step) — so the selected coordinates are the
engine's when its kernels are right, for every objective, private and not.

Direct |α| recomputation is exact, not an approximation: the engine's
sampler refreshes exactly the coordinates whose α changed each step (line
29 touches the rows' columns; α changes nowhere else), so its lazily kept
priorities always equal ``em_scale·|α|`` on real coordinates and the pad
value on padding — what this oracle rebuilds from scratch.

The scatter-adds (setup and line 26) take ``fw_torch.scatter_add``'s fixed
order: input order on the CPU, the stable sort's sums on the card (not the
kernel's order, so on the card a near-tie can go the other way:
``ROADMAP.md`` §C, C2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.fw_torch import scatter_add
from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.two_level import NEG_INF, _group_shape, logsumexp_rows
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR


def _ell_rmatvec_ref(pcsr: PaddedCSR, q: torch.Tensor) -> torch.Tensor:
    """Eager Xᵀq over the padded ELL rows, in row order (padding adds nothing)."""
    live = torch.arange(pcsr.indices.shape[1], device=q.device)[None, :] < pcsr.nnz[:, None]
    zeros = torch.zeros(pcsr.shape[1], dtype=pcsr.values.dtype, device=q.device)
    return scatter_add(zeros, pcsr.indices, pcsr.values * q[:, None], live)


def reference_fw(pcsr: PaddedCSR, pcsc: PaddedCSC, y, *, lam: float, steps: int,
                 private: bool = False, em_scale: float = 1.0, seed: int = 0,
                 loss: str = "logistic"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w, gaps, coords) of the ``fw_scan`` schedule, replayed eagerly."""
    obj = get_loss(loss)
    n, d = pcsr.shape
    dev = pcsr.device
    dtype = pcsr.values.dtype
    y = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor) else y,
                        dtype=dtype).to(dev)
    inv_n = 1.0 / n
    lam_t = torch.tensor(lam, dtype=dtype, device=dev)
    em_scale = float(np.float32(em_scale))

    # setup (Alg 2 lines 8-14); label-coupled objectives carry the full row
    # gradient in q̄ (no ȳ residual), as torch_sparse.fw_setup does
    vbar = torch.zeros(n, dtype=dtype, device=dev)
    if obj.separable:
        ybar = _ell_rmatvec_ref(pcsr, y) * inv_n
        qbar = obj.split_grad(vbar)
        alpha = _ell_rmatvec_ref(pcsr, qbar) * inv_n - ybar
    else:
        qbar = obj.grad(vbar, y)
        alpha = _ell_rmatvec_ref(pcsr, qbar) * inv_n

    g_grp, m_grp = _group_shape(d)
    lanes = torch.arange(pcsc.indices.shape[1], device=dev)
    row_lanes = torch.arange(pcsr.indices.shape[1], device=dev)
    w = torch.zeros(d, dtype=dtype, device=dev)
    w_m = torch.ones((), dtype=dtype, device=dev)
    g_tilde = torch.zeros((), dtype=dtype, device=dev)
    gaps = torch.zeros(steps, dtype=dtype, device=dev)
    coords = torch.zeros(steps, dtype=torch.int32, device=dev)
    key = prng.PRNGKey(seed)
    for step in range(1, steps + 1):
        key, sel_key = prng.split2(key)
        # ---- line 15: select coordinate (exact priorities from |α|) ------------
        if private:
            v = torch.full((g_grp * m_grp,), NEG_INF, dtype=dtype, device=dev)
            v[:d] = alpha.abs() * em_scale
            v = v.reshape(g_grp, m_grp)
            c = logsumexp_rows(v)
            kg, km = prng.split2(sel_key)
            g = torch.argmax(c + prng.gumbel(kg, c.shape, dev))
            noise = prng.gumbel(km, (1, m_grp), dev)
            j = g * m_grp + torch.argmax(v[g] + noise[0])
        else:
            j = torch.argmax(alpha.abs())
        j = torch.clamp_max(j, d - 1).reshape(1)
        a_j = alpha.index_select(0, j)[0]
        # ---- lines 16-21 -------------------------------------------------------
        d_tilde = torch.where(a_j == 0, lam_t, -lam * torch.sign(a_j))
        gaps[step - 1] = g_tilde - d_tilde * a_j
        coords[step - 1] = j[0].to(torch.int32)
        eta = float(np.float32(2.0) / (np.float32(step) + np.float32(2.0)))
        one_m_eta = float(np.float32(1.0) - np.float32(eta))
        w_m = w_m * one_m_eta
        w = w.index_add(0, j, ((eta * d_tilde) / w_m).reshape(1))
        g_tilde = g_tilde * one_m_eta + (eta * d_tilde) * a_j
        # ---- lines 22-28 (the fused kernel's sweep, unrolled) ------------------
        rows = pcsc.indices.index_select(0, j)[0].long()
        x_col = pcsc.values.index_select(0, j)[0]
        mask = lanes < pcsc.nnz.index_select(0, j)
        row_idx = pcsr.indices[rows].long()
        row_val = pcsr.values[rows]
        dv = torch.where(mask, (eta * d_tilde) * x_col / w_m, 0.0)
        vbar = scatter_add(vbar, rows, dv, mask)
        margins = w_m * vbar[rows]
        hm = obj.split_grad(margins) if obj.separable else obj.grad(margins, y[rows])
        gamma = torch.where(mask, hm - qbar[rows], 0.0)
        qbar = scatter_add(qbar, rows, gamma, mask)
        live = mask[:, None] & (row_lanes[None, :] < pcsr.nnz[rows][:, None])
        alpha = scatter_add(alpha, row_idx, (gamma * inv_n)[:, None] * row_val, live)
        dots = (row_val * w[row_idx]).sum(dim=1)
        g_tilde = g_tilde + w_m * torch.sum((gamma * inv_n) * dots)
    return w * w_m, gaps, coords
