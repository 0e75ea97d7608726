"""Distributed DP Frank-Wolfe on ``torch.distributed`` (``repro.distributed.fw_shard``).

Layout: rows over the grid's a axis, features over its b axis
(``collectives.ShardMesh``).  Every rank (ai, bj) holds one block of
``BlockSparse`` plus:

  state      split over          size a rank
  w, α       "model" (replicated over rows)   D/b
  v̄, q̄       "rows" (replicated over model)   N/a
  w_m, g̃     replicated                        scalars

The selection is the JAX package's Big-Step-Little-Step as a collective
schedule: each feature shard's log-sum-exp mass is one entry of the big
step's table, the winning shard is drawn by Gumbel-max over the b gathered
masses, and the winner's in-shard draw picks the coordinate.  A step
communicates:

  selection   all_gather of the b masses over "model"
  winner      psums over "model" of its index (int32), α_j and its column's
              (Kc,) lanes (int32 row ids, float32 values)
  α delta     psum of D/b floats over "rows", or with ``compress_topk`` = k an
              all_gather of k int32 indices and k values (error-feedback top-k: the
              residual stays on the rank and is re-added next step)
  g̃ dot      one psum over both axes
  coordinate  the global index j, a psum over "model" (int32)

The ops and the key schedule are the JAX package's, so on the CPU the port
takes its coordinates:

  * ``key, key_t = split(key)`` each step; for ``gumbel``, ``kg, km =
    split(key_t)``, the shard draw ``argmax(c + gumbel(kg, (b,)))``, then
    ``fold_in(km, bj)`` and the in-shard draw over ``d_loc``;
  * ``logsumexp`` as JAX computes it (max, shift, sum, log, add back);
  * ``top_k`` with JAX's tie rule (the lower index first), by a stable sort;
  * every scatter-add in input order, through ``kernels/scatter`` (the α
    setup, each step's v̄, q̄ and α delta, the gathered top-k): the kernel
    on the card, its plain version on the CPU.  A lane whose term is zero is
    dropped; the sums start at +0.0, so dropping ±0 terms keeps their bits.

A step walks the column's full padded ``Kc`` tile, as JAX does: reading j
on the host to walk only the live rows would cost a synchronisation a step.

Lanes: the JAX package vmaps a sweep group over (λ, EM scale, gap_tol, key)
on a 1×1 mesh.  Here the state carries a leading lane axis L: each lane has
its own scalars, key chain and state, the collectives are elementwise, and
each lane's scatters land in its own slice of one flat target space (lane
by lane, each in its own input order), so a lane of a group adds what its
own run adds.  One config is L = 1.

With ``early_stop`` the steps are masked as in JAX: the step that observes
``gap <= gap_tol`` is applied, every later one keeps the carry and writes the
sentinels (0.0, -1).  The gap is the same on every rank (it comes from psums),
so every rank freezes on the same step.  The key is not frozen: a frozen
lane's later draws are thrown away, so the outputs are JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.dp.accountant import em_log_weight_scale
from repro_torch.core.losses import get_loss
from repro_torch.core.solvers.torch_sparse import _div
from repro_torch.distributed.block_sparse import BlockSparse, LocalBlock
from repro_torch.distributed.collectives import LOCAL, ShardMesh
from repro_torch.kernels.scatter import scatter_add_ordered


@dataclasses.dataclass(frozen=True)
class DistFWConfig:
    """Native config of the distributed engine (the ``jax_shard`` backend
    builds the same run from an ``FWConfig``).  Private selection draws the
    exponential mechanism at the per-step budget of ``core.dp.accountant``,
    as every other backend does."""

    lam: float = 50.0
    steps: int = 1000
    loss: str = "logistic"
    selection: str = "gumbel"     # gumbel (DP exponential mechanism) | argmax
    epsilon: float = 1.0
    delta: float = 1e-6
    seed: int = 0
    compress_topk: int = 0        # 0: dense α-delta psum; k: error-feedback top-k exchange
    gap_tol: float = 0.0          # freeze the run once g_t <= gap_tol

    def em_scale(self, n_rows: int) -> float:
        if self.selection != "gumbel":
            return 1.0
        return em_log_weight_scale(epsilon=self.epsilon, delta=self.delta, steps=self.steps,
                                   n_rows=n_rows, lipschitz=get_loss(self.loss).lipschitz)


def _f32(x) -> float:
    return float(np.float32(x))


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.logsumexp`` over the last axis: max (0 where it is
    not finite), exp of the shifted values, sum, log, add the max back."""
    amax = x.max(dim=-1).values
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(x - amax[..., None]).sum(dim=-1)) + amax


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of ``jax.lax.top_k(x, k)`` over the last axis: largest first,
    equal values in index order."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def lane_scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                 live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L, m) ``dst`` with lane l's ``src[l]`` added at ``idx[l]`` in input
    order: one in-order scatter over the flat (L·m) targets."""
    lanes, m = dst.shape
    base = torch.arange(lanes, device=dst.device).reshape((lanes,) + (1,) * (idx.dim() - 1))
    flat = scatter_add_ordered(dst.reshape(-1), idx.long() + base * m, src, live)
    return flat.reshape(lanes, m)


def shard_setup(blk: LocalBlock, y_loc: torch.Tensor, *, n: int, loss: str,
                mesh: ShardMesh = LOCAL) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v̄₀, q̄₀, α₀) of this rank (Alg 2 lines 8-14): one local in-order
    scatter and one α psum over "rows"; shared by every (λ, ε) lane.
    Separable objectives fold the label into the residual (q̄ − y);
    label-coupled ones carry the full row gradient in q̄."""
    obj = get_loss(loss)
    csr_c, csr_v = blk.csr_cols, blk.csr_vals
    vbar0 = torch.zeros(csr_c.shape[0], dtype=torch.float32, device=csr_v.device)
    if obj.separable:
        qbar0 = obj.split_grad(vbar0)
        resid_q = _div(qbar0 - y_loc, n)
    else:
        qbar0 = obj.grad(vbar0, y_loc)
        resid_q = _div(qbar0, n)
    zeros = torch.zeros(blk.csc_rows.shape[0], dtype=torch.float32, device=csr_v.device)
    alpha_part = scatter_add_ordered(zeros, csr_c, resid_q[:, None] * csr_v, csr_v != 0)
    return vbar0, qbar0, mesh.psum(alpha_part, ("rows",))


def shard_scan(blk: LocalBlock, y_loc: torch.Tensor, setup, *, lams: Sequence[float],
               em_scales: Sequence[float], gap_tols: Sequence[float], keys: Sequence,
               steps: int, shape: Tuple[int, int], loss: str = "logistic",
               selection: str = "gumbel", compress_topk: int = 0, early_stop: bool = False,
               mesh: ShardMesh = LOCAL):
    """T steps of L lanes on this rank, from the shared setup (v̄₀, q̄₀, α₀).

    Returns (w (L, D_pad), gaps (L, T), coords (L, T) int32, stop_step (L,)),
    every output whole on every rank (w gathered over "model")."""
    obj = get_loss(loss)
    n, d = shape
    csc_r, csc_v, csr_c, csr_v = blk
    dev = csc_v.device
    f32 = torch.float32
    d_loc, kc = csc_r.shape
    kr = csr_c.shape[1]
    lanes = len(keys)
    my_b, b_sz = mesh.axis_index("model"), mesh.axis_size("model")
    col_valid = (my_b * d_loc + torch.arange(d_loc, device=dev)) < d
    lam = torch.tensor(lams, dtype=f32, device=dev)
    em = torch.tensor(em_scales, dtype=f32, device=dev)
    tol = torch.tensor(gap_tols, dtype=f32, device=dev)
    vbar0, qbar0, alpha0 = setup
    w_loc = torch.zeros(lanes, d_loc, dtype=f32, device=dev)
    w_m = torch.ones(lanes, dtype=f32, device=dev)
    g_t = torch.zeros(lanes, dtype=f32, device=dev)
    vbar = vbar0.expand(lanes, -1).clone()
    qbar = qbar0.expand(lanes, -1).clone()
    alpha = alpha0.expand(lanes, -1).clone()
    resid = torch.zeros(lanes, d_loc, dtype=f32, device=dev)
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    stop_at = torch.zeros(lanes, dtype=torch.int64, device=dev)
    gaps = torch.zeros(lanes, steps, dtype=f32, device=dev)
    coords = torch.zeros(lanes, steps, dtype=torch.int32, device=dev)
    keys = [tuple(int(v) for v in k) for k in keys]
    lane_ix = torch.arange(lanes, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=f32, device=dev)
    for t_int in range(1, steps + 1):
        old = (w_loc, w_m, g_t, vbar, qbar, alpha, resid)
        split = [prng.split2(k) for k in keys]
        keys = [nxt for nxt, _ in split]
        # ---- selection: shard draw over the b masses, then the winner's member
        logits = torch.where(col_valid, em[:, None] * alpha.abs(), neg_inf)
        if selection == "gumbel":
            c_all = mesh.all_gather(logsumexp(logits), "model").T           # (L, b)
            draws = [prng.split2(kt) for _, kt in split]
            big = torch.stack([prng.gumbel(kg, (b_sz,), dev) for kg, _ in draws])
            little = torch.stack([prng.gumbel(prng.fold_in(km, my_b), (d_loc,), dev)
                                  for _, km in draws])
            bw = torch.argmax(c_all + big, dim=1)
            j_self = torch.argmax(logits + little, dim=1)
        else:
            c_all = mesh.all_gather(logits.max(dim=1).values, "model").T
            bw = torch.argmax(c_all, dim=1)
            j_self = torch.argmax(logits, dim=1)
        mine = bw == my_b
        # the index psums send int32, as JAX does, and widen after the sum
        j_loc = mesh.psum(torch.where(mine, j_self, 0).to(torch.int32), ("model",)).long()
        alpha_j = mesh.psum(torch.where(mine, alpha[lane_ix, j_self], 0.0), ("model",))
        # ---- Alg 2 lines 16-21 (replicated scalars)
        d_tilde = torch.where(alpha_j == 0, lam, -lam * torch.sign(alpha_j))
        gap = g_t - d_tilde * alpha_j
        eta = _f32(np.float32(2.0) / (np.float32(t_int) + np.float32(2.0)))
        one_m_eta = _f32(np.float32(1.0) - np.float32(eta))
        w_m = w_m * one_m_eta
        step = (eta * d_tilde) / w_m
        w_loc = torch.where(mine[:, None], w_loc.index_put((lane_ix, j_loc), step,
                                                           accumulate=True), w_loc)
        g_t = g_t * one_m_eta + (eta * d_tilde) * alpha_j
        # ---- the winner's column lanes, summed over "model"
        rows_j = mesh.psum(torch.where(mine[:, None], csc_r[j_loc], 0), ("model",)).long()
        val_j = mesh.psum(torch.where(mine[:, None], csc_v[j_loc], 0.0), ("model",))
        lane_ok = val_j != 0.0
        # ---- v̄/q̄ updates (replicated over "model" within a row shard)
        dv = torch.where(lane_ok, ((eta * d_tilde)[:, None] * val_j) / w_m[:, None], 0.0)
        vbar = lane_scatter(vbar, rows_j, dv, lane_ok)
        margins = w_m[:, None] * vbar.gather(1, rows_j)
        hm = obj.split_grad(margins) if obj.separable else obj.grad(margins, y_loc[rows_j])
        gamma = torch.where(lane_ok, hm - qbar.gather(1, rows_j), 0.0)
        qbar = lane_scatter(qbar, rows_j, gamma, lane_ok)
        # ---- the α shard's delta from the touched rows' local columns
        gsc = _div(gamma, n)
        cols = csr_c[rows_j].long()                                          # (L, Kc, Kr)
        vals = torch.where(lane_ok[:, :, None], csr_v[rows_j], 0.0)
        zeros = torch.zeros(lanes, d_loc, dtype=f32, device=dev)
        delta = lane_scatter(zeros, cols, gsc[:, :, None] * vals, vals != 0)
        if compress_topk:
            resid = resid + delta
            topi = top_k(resid.abs(), compress_topk)                         # (L, k)
            sent = resid.gather(1, topi)
            resid = resid.scatter(1, topi, 0.0)
            gi = mesh.all_gather(topi.to(torch.int32), "rows").transpose(0, 1)  # (L, a, k)
            gv = mesh.all_gather(sent, "rows").transpose(0, 1)
            delta_sum = lane_scatter(zeros, gi, gv)
        else:
            delta_sum = mesh.psum(delta, ("rows",))
        alpha = alpha + delta_sum
        # ---- g̃ (line 27): partial dots reduced over both axes
        dots = (vals * w_loc.gather(1, cols.reshape(lanes, -1)).reshape(lanes, kc, kr)).sum(dim=2)
        g_t = g_t + mesh.psum((gsc * dots).sum(dim=1), ("rows", "model")) * w_m
        j_global = mesh.psum(torch.where(mine, my_b * d_loc + j_loc, 0).to(torch.int32),
                             ("model",)).long()
        if early_stop:
            newly = ~done & (tol > 0) & (gap <= tol)
            new = (w_loc, w_m, g_t, vbar, qbar, alpha, resid)
            w_loc, w_m, g_t, vbar, qbar, alpha, resid = (
                torch.where(done.reshape((lanes,) + (1,) * (o.dim() - 1)), o, fresh)
                for o, fresh in zip(old, new))
            gaps[:, t_int - 1] = torch.where(done, 0.0, gap)
            coords[:, t_int - 1] = torch.where(done, -1, j_global).to(torch.int32)
            stop_at = torch.where(newly, t_int, stop_at)
            done = done | newly
        else:
            gaps[:, t_int - 1] = gap
            coords[:, t_int - 1] = j_global.to(torch.int32)
    w = mesh.all_gather(w_loc * w_m[:, None], "model")                     # (b, L, D_loc)
    w = w.permute(1, 0, 2).reshape(lanes, b_sz * d_loc)
    stop_step = torch.where(done, stop_at, steps)
    return w, gaps, coords, stop_step


def rank_labels(y_pad: torch.Tensor, blocks: BlockSparse, mesh: ShardMesh) -> torch.Tensor:
    """This rank's row shard of the padded labels."""
    n_loc = blocks.padded[0] // blocks.grid[0]
    return y_pad[mesh.ai * n_loc:(mesh.ai + 1) * n_loc]


def distributed_fw(blocks: BlockSparse, y_pad, cfg: DistFWConfig, mesh: ShardMesh = LOCAL,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """T distributed FW steps of ``cfg`` on this rank's block, on ``device``
    (the card unless the caller asks for ``"cpu"``).  ``y_pad``: (N_pad,)
    labels padded with zeros.  Returns (w (D_pad,), gaps, coords,
    stop_step), whole on every rank."""
    from repro_torch.core.solvers.registry import check_device
    device = check_device(device)
    if blocks.grid != (mesh.a, mesh.b):
        raise ValueError(f"blocks of a {blocks.grid} grid on a ({mesh.a}, {mesh.b}) mesh")
    blk = blocks.local(mesh.ai, mesh.bj, device)
    y_loc = rank_labels(torch.as_tensor(y_pad, dtype=torch.float32).to(device), blocks, mesh)
    setup = shard_setup(blk, y_loc, n=blocks.shape[0], loss=cfg.loss, mesh=mesh)
    w, gaps, coords, stop = shard_scan(
        blk, y_loc, setup, lams=[cfg.lam], em_scales=[cfg.em_scale(blocks.shape[0])],
        gap_tols=[cfg.gap_tol], keys=[prng.PRNGKey(cfg.seed)], steps=cfg.steps,
        shape=blocks.shape, loss=cfg.loss, selection=cfg.selection,
        compress_topk=cfg.compress_topk, early_stop=cfg.gap_tol > 0, mesh=mesh)
    return w[0], gaps[0], coords[0], stop[0]
