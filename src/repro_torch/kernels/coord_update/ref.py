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

import numpy as np
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
    # a row that column j lists twice (a repeated entry) takes both lanes'
    # v̄ terms, then each lane its γ, in lane order (the JAX package's
    # scatter-adds; index_add_ adds in index order on the CPU)
    rows, xv = pcsc.col_live(jj)
    rows = rows.long()
    vbar.index_add_(0, rows, edt * xv / wm)
    vb = vbar[rows]
    hm = obj.h(wm * vb, None if obj.separable else y[rows])
    gamma = hm - qbar[rows]
    qbar.index_add_(0, rows, gamma)
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


def coord_update_lanes_ref(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, *,
                           t: float, scalars, inv_n: float, loss: str, gaps: torch.Tensor,
                           coords: torch.Tensor, slot: int, done=None, stop_at=None) -> None:
    """The lane form's plain version: ``coord_update_ref`` on each lane's
    rows of the stacked state, with the lane's own λ, EM scale and gap_tol
    (``scalars``, a ``LaneScalars``)."""
    for b in range(scalars.lanes):
        coord_update_ref(j[b:b + 1], pcsr, pcsc, y, w[b], w_m[b], g_tilde[b], vbar[b], qbar[b],
                         alpha[b], queue.lane(b), t=t, lam=scalars.lam[b], inv_n=inv_n,
                         em_scale=scalars.em_scale[b], loss=loss, gaps=gaps[b],
                         coords=coords[b], slot=slot, done=None if done is None else done[b],
                         stop_at=None if stop_at is None else stop_at[b],
                         gap_tol=scalars.gap_tol[b])


# ---- line 26's order, stated two ways ------------------------------------------
#
# The kernel's α is bitwise equal to ``coord_update_ref``'s: every α[c] is
# ((α_old[c] + t₁) + t₂) + … with tₖ = γᵢ/N · x_ic over the rows i of column j
# that hold c, in ascending row order.  ``scatter_alpha_rows`` is line 61 above
# (``index_add_`` adds in index order on the CPU, and the rows' live lanes are
# row-major); ``scatter_alpha_owners`` is the same sums as the kernel's long
# route makes them, each touched column walking its own rows.


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit as floats: ``torch.equal`` and the same signs of zero."""
    return torch.equal(a, b) and torch.equal(torch.signbit(a.float()), torch.signbit(b.float()))


def lane_terms(rows: torch.Tensor, gs: torch.Tensor, pcsr):
    """Column ids and terms γᵢ/N·x_ic of column j's rows' live lanes, row-major."""
    ridx = pcsr.indices[rows.long()].long()
    rval = pcsr.values[rows.long()]
    live = torch.arange(ridx.shape[1], device=ridx.device)[None, :] < \
        pcsr.nnz[rows.long()][:, None]
    return ridx[live], (gs[:, None] * rval)[live]


def scatter_alpha_rows(alpha: torch.Tensor, rows: torch.Tensor, gs: torch.Tensor,
                       pcsr) -> torch.Tensor:
    """α after line 26 from ``alpha`` (α_old) and γᵢ/N of column j's lanes, as
    ``coord_update_ref`` adds it: a row at a time, in lane order."""
    cols, terms = lane_terms(rows, gs, pcsr)
    return alpha.clone().index_add_(0, cols, terms)


def _repeat_runs(r: torch.Tensor, v: torch.Tensor, mult: torch.Tensor):
    """Column c's walk when column j lists a row on several lanes: each run
    of c's entries of one row, repeated once per lane of j that lists the
    row (non-members drop out)."""
    r_np = r.cpu().numpy()
    starts = np.flatnonzero(np.r_[True, r_np[1:] != r_np[:-1]]) if r_np.size else []
    ends = np.r_[starts[1:], r_np.size] if r_np.size else []
    take = [np.tile(np.arange(a, b), int(mult[r_np[a]])) for a, b in zip(starts, ends)]
    take = torch.from_numpy(np.concatenate(take or [np.zeros(0, np.int64)])).to(r.device)
    return r[take], v[take]


def scatter_alpha_owners(alpha: torch.Tensor, rows: torch.Tensor, gs: torch.Tensor,
                         pcsr, pcsc) -> torch.Tensor:
    """α after line 26 in the column-owner order: each touched column c walks
    its CSC rows in ascending order (a row's repeated entries in lane order),
    skips the rows that are not column j's (never adding them as +0, which
    would turn -0.0 into +0.0), and chains the members' products onto
    α_old[c].  A row that column j lists on m lanes adds its run of c's
    entries m times over (the kernel's ``repeat_walk``)."""
    n = pcsr.shape[0]
    out = alpha.clone()
    g_row = torch.zeros(n, dtype=gs.dtype, device=gs.device)
    member = torch.zeros(n, dtype=torch.bool, device=gs.device)
    g_row[rows.long()] = gs     # the lanes of one row carry one γ
    member[rows.long()] = True
    mult = torch.bincount(rows.long(), minlength=n)
    touched = torch.unique(lane_terms(rows, gs, pcsr)[0])
    if touched.numel() == 0:
        return out
    walks = [pcsc.col_live(int(c)) for c in touched]
    if int(mult.max()) > 1:
        walks = [_repeat_runs(r.long(), v, mult) for r, v in walks]
    width = max(int(r.numel()) for r, _ in walks)
    crow = torch.zeros((len(walks), width), dtype=torch.long, device=gs.device)
    cval = torch.zeros((len(walks), width), dtype=gs.dtype, device=gs.device)
    valid = torch.zeros((len(walks), width), dtype=torch.bool, device=gs.device)
    for k, (r, v) in enumerate(walks):
        crow[k, :r.numel()], cval[k, :r.numel()], valid[k, :r.numel()] = r.long(), v, True
    keep = valid & member[crow]
    terms = g_row[crow] * cval
    acc = out[touched]
    for lane in range(width):
        acc = torch.where(keep[:, lane], acc + terms[:, lane], acc)
    out[touched] = acc
    return out


def refresh_queue_(queue, cols: torch.Tensor, alpha: torch.Tensor, em_scale: float) -> None:
    """Line 29 at the touched columns ``cols`` from ``alpha`` (in place)."""
    fresh = alpha[cols.long()].abs()
    if isinstance(queue, TwoLevelSamplerState):
        tl_scatter_(queue, cols, fresh * em_scale)
    else:
        ga_scatter_(queue, cols, fresh)


def bitwise_rule_mismatches(j: int, pcsr, pcsc, y, before: dict, after: dict,
                            gs: torch.Tensor, **step) -> list:
    """The outputs of one card step that break the kernel's bitwise rule.

    ``before``: the state the step started from, on the CPU (``w``, ``w_m``,
    ``g_tilde``, ``vbar``, ``qbar``, ``alpha``, ``queue``); ``after``: the
    card's state after the step, moved to the CPU (the same keys, and
    ``gaps``/``coords``: the step's slot, shape (1,)); ``gs``: the card's γᵢ/N in lane order;
    ``step``: ``coord_update_ref``'s keywords but ``gaps``/``coords``/``slot``.
    ``pcsr``/``pcsc`` on the CPU (``pcsc`` needs only ``col_live``).

    α must equal line 61 fed the card's γ; v̄, w, w_m, the gap and the
    coordinate ``coord_update_ref``; the queue the line-29 refresh of the
    card's own α.  q̄ and g̃ are held allclose (rtol 1e-5, atol 1e-6): the
    logistic map's ``expf`` and ``torch.sigmoid`` may round an ulp apart,
    and Δg̃ sums in another order.
    """
    ref = {k: v.clone() for k, v in before.items()}
    gaps, coords = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
    coord_update_ref(torch.tensor([j], dtype=torch.int32), pcsr, pcsc, y, ref["w"],
                     ref["w_m"], ref["g_tilde"], ref["vbar"], ref["qbar"], ref["alpha"],
                     ref["queue"], gaps=gaps, coords=coords, slot=0, **step)
    rows, _ = pcsc.col_live(min(j, before["alpha"].shape[0] - 1))
    bad = []
    if gs.shape != rows.shape:
        return ["gs"]
    alpha = scatter_alpha_rows(before["alpha"], rows, gs, pcsr)
    exact = dict(alpha=(after["alpha"], alpha), vbar=(after["vbar"], ref["vbar"]),
                 w=(after["w"], ref["w"]), w_m=(after["w_m"], ref["w_m"]),
                 gap=(after["gaps"], gaps), coord=(after["coords"], coords))
    queue = before["queue"].clone()
    refresh_queue_(queue, lane_terms(rows, gs, pcsr)[0], after["alpha"],
                   step.get("em_scale", 1.0))
    if isinstance(queue, TwoLevelSamplerState):
        exact.update(prio=(after["queue"].v, queue.v), touched=(after["queue"].touched,
                                                                 queue.touched))
    else:
        exact.update(prio=(after["queue"].p, queue.p), bound=(after["queue"].bound,
                                                               queue.bound))
    for name, (got, want) in exact.items():
        if not same_bits(got.reshape(-1), want.reshape(-1).to(got.dtype)):
            bad.append(name)
    for name in ("qbar", "g_tilde"):
        if not torch.allclose(after[name], ref[name], rtol=1e-5, atol=1e-6):
            bad.append(name)
    return bad
