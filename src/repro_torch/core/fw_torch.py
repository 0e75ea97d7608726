"""``torch_dense`` — Algorithm 2's state machine with dense vector updates
(``repro.core.fw_jax``, the JAX package's ``jax_dense`` engine).

The same state machine as ``fw_jax.sparse_fw_jax``, step for step, in plain
torch ops on one device:

  * setup — ȳ and α₀ through ``kernels/spmv``'s ``ell_rmatvec``
    (``torch_sparse.fw_setup``: two launches on the card);
  * line 15 — the two-level exponential-mechanism draw (``tl_sample``:
    Gumbel noise from the JAX key stream, one ``key, sel = split(key)`` a
    step) or the lazy group argmax (``ga_get_next``, the port's host loop);
  * lines 16-28 — the selected column's rows walked with dense vector
    gathers and scatters over the ``K_col × K_row`` tile of their CSR rows;
  * line 29 — every lane of the tile refreshes its coordinate's priority
    (``tl_update``, whose rebuild on the card is the draw kernel's
    rebuild-only launch; ``ga_update``).

The tile: ``"full"`` walks JAX's static tile (all ``K_col`` padded rows;
the padding rows point at row 0 with a zero γ), ``"live"`` only the
column's ``nnz[j]`` rows, which is exact but needs ``j`` on the host.  The
non-private queue has ``j`` on the host anyway, and there the live tile
halves the step at the rcv1.binary shape; a private step on the card would
pay a synchronisation for it and gains nothing measurable, so it walks the
full tile there (``PERF.md`` §6).  On the CPU a host read costs nothing and
the live rows are far fewer lanes, so every CPU run walks them.  Lanes
outside the live entries add nothing: the scatters drop them.

The scatter-adds go through ``kernels/scatter``'s ``scatter_add_ordered``:
each target's terms are added in input order, the JAX package's order, on
the CPU (its plain version, ``index_add_``) and on the card (its kernel, one
chain per target), so the card takes the CPU's bits and the CPU takes
JAX's.

Private steps keep everything on the device: no host read of ``j`` or of
``done``.  With ``gap_tol`` the run is masked as in
JAX: the step that observes ``g_t <= gap_tol`` is applied, every later one
keeps the carry (the sampler's state included) and writes the sentinels
(0.0, -1); ``stop_step`` stays a device scalar until the caller reads it.
The non-private host queue reads ``done`` before each pop, as
``torch_sparse`` does, and stops popping once it is set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.dp.accountant import per_step_epsilon
from repro_torch.core.samplers.group_argmax import ga_get_next, ga_init, ga_update
from repro_torch.core.samplers.two_level import (TwoLevelSamplerState, tl_init, tl_sample,
                                                 tl_update)
from repro_torch.core.solvers.config import FWConfig, FWResult
from repro_torch.core.solvers.torch_sparse import _div, fw_setup
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR
from repro_torch.kernels.scatter import scatter_add_ordered

TILES = ("full", "live")


def default_tile(private: bool, device) -> str:
    """The tile a run walks unless forced: full for a private run on the
    card (no host read of ``j``), the live rows otherwise (``j`` is on the
    host already, or reading it costs nothing)."""
    return "full" if private and torch.device(device).type == "cuda" else "live"


@dataclasses.dataclass(frozen=True)
class SparseTorchConfig(FWConfig):
    queue: str = "two_level"   # two_level (DP) | group_argmax (non-private)


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """``dst`` with ``src`` added at ``idx`` (functional): each target's live
    lanes in input order, on the CPU and on the card; a dead lane adds
    nothing (``kernels/scatter``)."""
    return scatter_add_ordered(dst, idx, src, live)


def _where(done: torch.Tensor, old, new):
    """``new`` until ``done``, then ``old``: a tensor or a sampler state."""
    if isinstance(new, torch.Tensor):
        return torch.where(done, old, new)
    if isinstance(new, TwoLevelSamplerState):
        return TwoLevelSamplerState(torch.where(done, old.v, new.v),
                                    torch.where(done, old.c, new.c), new.d,
                                    torch.where(done, old.touched, new.touched))
    return dataclasses.replace(new, p=torch.where(done, old.p, new.p),
                               bound=torch.where(done, old.bound, new.bound))


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a Python float the float32 ops take exactly)."""
    return float(np.float32(x))


def sparse_fw_torch(pcsr: PaddedCSR, pcsc: PaddedCSC, y: torch.Tensor,
                    config: SparseTorchConfig, *, tile: Optional[str] = None,
                    setup=None) -> FWResult:
    """One run of ``config.steps`` steps of the ``fw_jax`` state machine on
    ``pcsr``'s device; ``setup`` injects (v̄₀, q̄₀, α₀) as ``fw_setup``
    computes them (a dataset store's cache).  ``tile`` forces a tile (both
    give the same coordinates and w; the gaps differ in the blocking of
    g̃'s sum); by default ``default_tile`` picks it.  Returns the
    ``FWResult`` whose ``stop_step`` is a device scalar."""
    if not isinstance(pcsc, PaddedCSC):
        raise ValueError("torch_dense walks a flat PaddedCSC tile; got "
                         f"{type(pcsc).__name__}")
    private = config.queue == "two_level"
    tile = default_tile(private, pcsr.device) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}; got {tile!r}")
    n, d = pcsr.shape
    dev = pcsr.device
    dtype = pcsr.values.dtype
    lam = config.lam
    loss = config.loss_fn()
    separable = loss.separable
    if private:
        eps_step = per_step_epsilon(config.epsilon, config.delta, config.steps)
        em_scale = eps_step * n / (2.0 * loss.lipschitz)
    else:
        em_scale = 1.0   # priorities are raw |α|
    if setup is None:
        setup = fw_setup(pcsr, y, loss=config.loss, pcsc=pcsc)
    vbar, qbar, alpha = (t.clone() for t in setup)
    w = torch.zeros(d, dtype=dtype, device=dev)
    w_m = torch.ones((), dtype=dtype, device=dev)
    g_tilde = torch.zeros((), dtype=dtype, device=dev)
    sampler = tl_init(alpha.abs() * em_scale) if private else ga_init(alpha.abs())
    masked = config.gap_tol > 0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stop_at = torch.zeros((), dtype=torch.int32, device=dev)
    steps = config.steps
    gaps = torch.zeros(steps, dtype=dtype, device=dev)
    coords = torch.full((steps,), -1, dtype=torch.int32, device=dev)
    col_nnz = pcsc.nnz.cpu().numpy()      # the live tile's lane counts, on the host
    row_nnz = pcsr.nnz.long()
    lane_k = torch.arange(pcsr.indices.shape[1], device=dev)
    lam_t = torch.tensor(lam, dtype=dtype, device=dev)
    key = prng.PRNGKey(config.seed)
    for t_int in range(1, steps + 1):
        key, sel_key = prng.split2(key)
        # ---- line 15: select coordinate ---------------------------------------
        if private:
            j = tl_sample(sampler, sel_key).reshape(1)
            sampler_sel = sampler
        else:
            if masked and bool(done):   # a frozen run pops nothing more
                break
            j_host, sampler_sel = ga_get_next(sampler)
            j = torch.full((1,), j_host, dtype=torch.long, device=dev)
        j = torch.clamp_max(j, d - 1)
        a_j = alpha.index_select(0, j)[0]
        # ---- lines 16-21 --------------------------------------------------------
        d_tilde = torch.where(a_j == 0, lam_t, -lam * torch.sign(a_j))
        gap = g_tilde - d_tilde * a_j
        eta = _f32(np.float32(2.0) / (np.float32(t_int) + np.float32(2.0)))
        one_m_eta = _f32(np.float32(1.0) - np.float32(eta))
        w_m_new = w_m * one_m_eta
        w_new = w.index_add(0, j, ((eta * d_tilde) / w_m_new).reshape(1))
        g_tilde_new = g_tilde * one_m_eta + (eta * d_tilde) * a_j
        # ---- lines 22-28: the rows holding feature j ------------------------------
        if tile == "full":
            rows = pcsc.indices.index_select(0, j)[0].long()
            xvals = pcsc.values.index_select(0, j)[0]
            mask = torch.arange(rows.shape[0], device=dev) < pcsc.nnz.index_select(0, j)
        else:
            j_live = int(j) if private else min(j_host, d - 1)   # private: a host read
            k = int(col_nnz[j_live])
            rows = pcsc.indices[j_live, :k].long()
            xvals = pcsc.values[j_live, :k]
            mask = torch.ones(k, dtype=torch.bool, device=dev)
        dv = torch.where(mask, (eta * d_tilde) * xvals / w_m_new, 0.0)
        vbar_new = scatter_add(vbar, rows, dv, mask)
        margins = w_m_new * vbar_new[rows]
        hm = loss.split_grad(margins) if separable else loss.grad(margins, y[rows])
        gamma = torch.where(mask, hm - qbar[rows], 0.0)
        qbar_new = scatter_add(qbar, rows, gamma, mask)
        row_idx = pcsr.indices[rows].long()                 # (K, K_row)
        row_val = pcsr.values[rows]                         # 0 at padding
        live = mask[:, None] & (lane_k[None, :] < row_nnz[rows][:, None])
        gn = _div(gamma, n)
        alpha_new = scatter_add(alpha, row_idx, gn[:, None] * row_val, live)
        # line 27: g̃ += Σᵢ (γᵢ/N)·⟨X[i,:], w̃⟩·w_m
        dots = (row_val * w_new[row_idx]).sum(dim=1)
        g_tilde_new = g_tilde_new + w_m_new * torch.sum(gn * dots)
        # ---- line 29: refresh the touched coordinates' priorities --------------
        flat_idx = row_idx.reshape(-1)
        fresh = alpha_new[flat_idx].abs() * em_scale
        sampler_new = (tl_update(sampler_sel, flat_idx, fresh) if private
                       else ga_update(sampler_sel, flat_idx, fresh))
        j32 = j[0].to(torch.int32)
        new = (w_new, w_m_new, g_tilde_new, vbar_new, qbar_new, alpha_new, sampler_new)
        if masked:
            newly = ~done & (gap <= config.gap_tol)
            old = (w, w_m, g_tilde, vbar, qbar, alpha, sampler)
            new = tuple(_where(done, o, fresh_leaf) for o, fresh_leaf in zip(old, new))
            gaps[t_int - 1] = torch.where(done, 0.0, gap)
            coords[t_int - 1] = torch.where(done, -1, j32)
            stop_at = torch.where(newly, t_int, stop_at)
            done = done | newly
        else:
            gaps[t_int - 1] = gap
            coords[t_int - 1] = j32
        w, w_m, g_tilde, vbar, qbar, alpha, sampler = new
    stop_step = torch.where(done, stop_at, steps)
    return FWResult(w=w * w_m, gaps=gaps, coords=coords, losses=torch.zeros_like(gaps),
                    stop_step=stop_step, stop_reason="max_steps")
