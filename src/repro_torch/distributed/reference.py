"""Straight-line oracle of the ``jax_shard`` schedule on a 1×1 grid
(``repro.distributed.reference``).

``reference_fw`` replays ``fw_shard``'s step with direct global indexing: no
collectives, no winner masking, no lanes.  Every psum is the identity and
the shard-then-member Gumbel-max collapses to one in-shard draw (the b = 1
big step consumes ``kg`` and picks shard 0), with the same key stream, so
the coordinates must equal the engine's when its collective plumbing is
right.  It is the court for the private path, where no other engine draws
the same noise; the non-private path is also held to ``host_sparse``.

Its scatter-adds are ``fw_torch.scatter_add`` (in input order, the card's
kernel or the CPU's plain version) over the full padded lanes, as JAX's
``.at[].add`` takes them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.fw_torch import scatter_add
from repro_torch.core.losses import get_loss
from repro_torch.core.solvers.torch_sparse import _div
from repro_torch.distributed.block_sparse import BlockSparse


def reference_fw(blocks: BlockSparse, y_pad, *, lam: float, steps: int,
                 selection: str = "gumbel", em_scale: float = 1.0, seed: int = 0,
                 loss: str = "logistic", device="cuda"):
    """(w (D_pad,), gaps, coords) of the ``fw_shard`` schedule on a 1×1 grid,
    on ``device`` (the card unless the caller asks for ``"cpu"``)."""
    from repro_torch.core.solvers.registry import check_device
    if blocks.grid != (1, 1):
        raise ValueError("reference_fw replays the single-device schedule; "
                         f"got a {blocks.grid} grid")
    device = check_device(device)
    obj = get_loss(loss)
    csc_r, csc_v, csr_c, csr_v = blocks.local(0, 0, device)
    y_pad = torch.as_tensor(y_pad, dtype=torch.float32).to(device)
    n, d = blocks.shape
    n_pad, d_pad = blocks.padded
    f32 = torch.float32
    col_valid = torch.arange(d_pad, device=device) < d
    lam_t = torch.tensor(lam, dtype=f32, device=device)
    em = float(np.float32(em_scale))

    vbar = torch.zeros(n_pad, dtype=f32, device=device)
    if obj.separable:
        qbar = obj.split_grad(vbar)
        resid_q = _div(qbar - y_pad, n)
    else:
        qbar = obj.grad(vbar, y_pad)
        resid_q = _div(qbar, n)
    alpha = scatter_add(torch.zeros(d_pad, dtype=f32, device=device), csr_c,
                        resid_q[:, None] * csr_v, csr_v != 0)

    w = torch.zeros(d_pad, dtype=f32, device=device)
    w_m = torch.ones((), dtype=f32, device=device)
    g_t = torch.zeros((), dtype=f32, device=device)
    key = prng.PRNGKey(seed)
    gaps, coords = [], []
    for step in range(1, steps + 1):
        key, key_t = prng.split2(key)
        logits = torch.where(col_valid, em * alpha.abs(), -float("inf"))
        if selection == "gumbel":
            _, km = prng.split2(key_t)           # kg draws the b = 1 big step
            j = torch.argmax(logits + prng.gumbel(prng.fold_in(km, 0), (d_pad,), device))
        else:
            j = torch.argmax(logits)
        a_j = alpha[j]
        d_tilde = torch.where(a_j == 0, lam_t, -lam * torch.sign(a_j))
        gaps.append(g_t - d_tilde * a_j)
        coords.append(j)
        eta = float(np.float32(2.0) / (np.float32(step) + np.float32(2.0)))
        w_m = w_m * float(np.float32(1.0) - np.float32(eta))
        w = w.index_put((j.reshape(1),), ((eta * d_tilde) / w_m).reshape(1), accumulate=True)
        g_t = g_t * float(np.float32(1.0) - np.float32(eta)) + (eta * d_tilde) * a_j

        rows_j, val_j = csc_r[j].long(), csc_v[j]
        lane_ok = val_j != 0.0
        dv = torch.where(lane_ok, ((eta * d_tilde) * val_j) / w_m, 0.0)
        vbar = scatter_add(vbar, rows_j, dv, lane_ok)
        margins = w_m * vbar[rows_j]
        hm = obj.split_grad(margins) if obj.separable else obj.grad(margins, y_pad[rows_j])
        gamma = torch.where(lane_ok, hm - qbar[rows_j], 0.0)
        qbar = scatter_add(qbar, rows_j, gamma, lane_ok)

        gsc = _div(gamma, n)
        cols = csr_c[rows_j].long()
        vals = torch.where(lane_ok[:, None], csr_v[rows_j], 0.0)
        alpha = alpha + scatter_add(torch.zeros(d_pad, dtype=f32, device=device), cols,
                                    gsc[:, None] * vals, vals != 0)
        dots = (vals * w[cols]).sum(dim=1)
        g_t = g_t + (gsc * dots).sum() * w_m
    return w * w_m, torch.stack(gaps), torch.stack(coords).to(torch.int32)
