"""``torch_sparse`` backend — Algorithm 2 through the port's CUDA kernels.

Port of ``repro.core.solvers.jax_sparse`` (fixed-T path):

  * setup           — ``kernels/spmv`` ``ell_rmatvec`` builds ȳ and α₀ (one
                      sweep each; one for label-coupled objectives);
  * line 15 select  — ``kernels/bsls_draw`` ``two_level_draw`` (private), or
                      the lazy group argmax (``core/samplers/group_argmax``);
  * lines 16-29     — ``kernels/coord_update`` ``coord_update``: scalars,
                      the fused coordinate update and the queue refresh in
                      one launch; the private queue then rebuilds its group
                      log-sum-exps (``tl_rebuild_``).

The JAX ``lax.scan`` becomes a Python loop that launches kernels.  The state
lives in a mutable ``FWCarry`` and is updated in place (the JAX carry is
immutable; in place saves a copy of every state vector per step).  Each
step's gap and coordinate land in preallocated device tensors indexed by
step, so the private path runs T steps without a host synchronisation; the
non-private queue synchronises once per lazy-repair pop.

The key chain ``key, sel_t = split(key)`` depends on nothing but the key and
T, so it is computed on the host once per chunk; the draw kernel receives
each step's selection key as two uint32 arguments.

Early stopping (``gap_tol``, ``max_seconds``) runs the masked form of the
chunk under the shared chunk loop (``stopping.drive_chunks``).  The masking is
on the device: ``coord_update`` sets the carry's ``done``/``stop_at`` on the
step whose gap is ``<= gap_tol`` and applies it; every later launch of it and
of the draw finds ``done`` set and writes only the sentinels (0.0, -1), so
the private path still runs without a host round trip.  The non-private
host queue reads ``done`` before each pop and leaves a frozen queue alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch import prng
from repro_torch.core.dp.accountant import em_log_weight_scale
from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.group_argmax import (GroupArgmaxState, ga_get_next,
                                                    ga_init)
from repro_torch.core.samplers.two_level import (TwoLevelSamplerState, tl_init,
                                                 tl_rebuild_)
from repro_torch.core.solvers.config import STOP_MAX_STEPS, FWConfig, FWResult
from repro_torch.core.solvers.stopping import assemble_outputs, drive_chunks, resolve_chunk
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR, TieredCSC
from repro_torch.kernels.bsls_draw.ops import two_level_draw
from repro_torch.kernels.coord_update.ops import coord_update, coord_update_scratch
from repro_torch.kernels.spmv.ops import ell_rmatvec

ColumnLayout = Union[PaddedCSC, TieredCSC]


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    # a tensor divisor keeps true division on CUDA, where a Python scalar
    # divisor becomes a multiplication by its reciprocal
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def fw_setup(pcsr: PaddedCSR, y: torch.Tensor, *, loss: str,
             pcsc: Optional[ColumnLayout] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Config-independent solve state (v̄₀, q̄₀, α₀) via ``ell_rmatvec``.

    Separable objectives use the ȳ decomposition; label-coupled ones carry
    the full row gradient in q̄ (α = Xᵀq̄/N, no ȳ term).  ``pcsc`` is the
    column layout the CUDA kernel gathers over.
    """
    n = pcsr.shape[0]
    obj = get_loss(loss)
    vbar0 = torch.zeros(n, dtype=pcsr.values.dtype, device=pcsr.device)
    if obj.separable:
        ybar = _div(ell_rmatvec(pcsr, y, pcsc), n)
        qbar0 = obj.split_grad(vbar0)
        alpha0 = _div(ell_rmatvec(pcsr, qbar0, pcsc), n) - ybar
    else:
        qbar0 = obj.grad(vbar0, y)
        alpha0 = _div(ell_rmatvec(pcsr, qbar0, pcsc), n)
    return vbar0, qbar0, alpha0


@dataclasses.dataclass
class FWCarry:
    """Full loop state of one Frank-Wolfe run (the JAX ``FWCarry`` fields).

    ``w_m``/``g_tilde`` are 0-d device tensors; ``key`` is the uint32[2] PRNG
    key as an int64 CPU tensor; ``done`` (bool) and ``stop_at`` (int32, the
    number of steps applied once ``done`` is set) are the early-stopping
    flags, on the device.
    """

    w: torch.Tensor
    w_m: torch.Tensor
    g_tilde: torch.Tensor
    vbar: torch.Tensor
    qbar: torch.Tensor
    alpha: torch.Tensor
    sampler: Union[TwoLevelSamplerState, GroupArgmaxState]
    key: torch.Tensor
    done: torch.Tensor
    stop_at: torch.Tensor


def fw_carry_init(d: int, dtype, vbar0, qbar0, alpha0, em_scale, key,
                  *, private: bool) -> FWCarry:
    """Loop carry at t = 0 (copies the setup state, which the loop mutates)."""
    dev = alpha0.device
    em = torch.tensor(em_scale, dtype=dtype, device=dev)
    sampler = tl_init(alpha0.abs() * em) if private else ga_init(alpha0.abs())
    return FWCarry(
        w=torch.zeros(d, dtype=dtype, device=dev),
        w_m=torch.tensor(1.0, dtype=dtype, device=dev),
        g_tilde=torch.tensor(0.0, dtype=dtype, device=dev),
        vbar=vbar0.clone(), qbar=qbar0.clone(), alpha=alpha0.clone(),
        sampler=sampler, key=torch.as_tensor(key, dtype=torch.int64).clone(),
        done=torch.tensor(False, device=dev),
        stop_at=torch.tensor(0, dtype=torch.int32, device=dev))


def fw_scan_chunk(pcsr: PaddedCSR, pcsc: ColumnLayout, carry: FWCarry,
                  lam, em_scale, gap_tol, t0: int, y=None, *, steps: int, loss: str,
                  private: bool, early_stop: bool = False
                  ) -> Tuple[FWCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Advance ``carry`` (in place) by ``steps`` iterations after global step
    ``t0``; returns (carry, (gaps, coords)) for this chunk.

    ``y`` (labels) is required for label-coupled objectives.  With
    ``early_stop`` the chunk is masked: the step that observes
    ``g_t <= gap_tol`` is still applied, after it the carry (PRNG key
    included) stays as it was and the outputs are (0.0, -1).  The key is
    settled after the chunk, which reads ``done`` back once.
    """
    n, _ = pcsr.shape
    obj = get_loss(loss)
    if not obj.separable and y is None:
        raise ValueError(f"loss {loss!r} is label-coupled; pass y")
    dev = carry.alpha.device
    gaps = torch.zeros(steps, dtype=torch.float32, device=dev)
    coords = torch.zeros(steps, dtype=torch.int32, device=dev)
    j = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = coord_update_scratch(n, pcsr.shape[1], dev) if dev.type == "cuda" else None
    key_next, sel_keys = prng.key_chain(carry.key, steps)
    mask = dict(done=carry.done, stop_at=carry.stop_at, gap_tol=float(gap_tol)) \
        if early_stop else {}
    for i in range(steps):
        # ---- line 15: select coordinate --------------------------------------
        if private:
            two_level_draw(carry.sampler.c, carry.sampler.v, sel_keys[i], out=j,
                           done=mask.get("done"))
        else:
            if early_stop and bool(carry.done):   # frozen: the queue stays as it is
                coords[i:] = -1
                break
            jj, carry.sampler = ga_get_next(carry.sampler)
            j.fill_(jj)
        # ---- lines 16-29 ---------------------------------------------------------
        coord_update(j, pcsr, pcsc, y, carry.w, carry.w_m, carry.g_tilde, carry.vbar,
                     carry.qbar, carry.alpha, carry.sampler, t=float(t0 + i + 1), lam=lam,
                     inv_n=1.0 / n, em_scale=em_scale, loss=loss, gaps=gaps,
                     coords=coords, slot=i, scratch=scratch, **mask)
        if private:
            tl_rebuild_(carry.sampler)   # no group touched after done: c unchanged
    if early_stop and bool(carry.done):
        ran = min(max(int(carry.stop_at) - t0, 0), steps)
        key_next = prng.key_chain(carry.key, ran)[0]
    carry.key = key_next
    return carry, (gaps, coords)


def fw_scan(pcsr: PaddedCSR, pcsc: ColumnLayout, vbar0, qbar0, alpha0, lam, em_scale,
            key, gap_tol=0.0, y=None, *, steps: int, loss: str, private: bool,
            early_stop: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Whole run; returns (w, gaps, coords, stop_step)."""
    carry = fw_carry_init(pcsr.shape[1], pcsr.values.dtype, vbar0, qbar0, alpha0,
                          em_scale, key, private=private)
    carry, (gaps, coords) = fw_scan_chunk(
        pcsr, pcsc, carry, lam, em_scale, gap_tol, 0, y, steps=steps, loss=loss,
        private=private, early_stop=early_stop)
    stop_step = torch.where(carry.done, carry.stop_at, steps)
    return carry.w * carry.w_m, gaps, coords, stop_step


def em_scale_for(config: FWConfig, n_rows: int) -> float:
    """EM log-weight scale ε'·N/(2L) when the queue is the DP two-level
    sampler; 1.0 otherwise (priorities are then raw |α|)."""
    if config.queue != "two_level":
        return 1.0
    return em_log_weight_scale(
        epsilon=config.epsilon, delta=config.delta, steps=config.steps,
        n_rows=n_rows, lipschitz=config.loss_fn().lipschitz)


def _chunked_fw(pcsr, pcsc, setup, config: FWConfig, em_scale: float, private: bool,
                y=None) -> FWResult:
    """Masked chunks under the shared chunk loop until the gap certificate
    lands, ``max_seconds`` expires, or T is spent."""
    carry0 = fw_carry_init(pcsr.shape[1], pcsr.values.dtype, *setup, em_scale,
                           prng.PRNGKey(config.seed), private=private)

    def advance(carry, t0, c):
        return fw_scan_chunk(pcsr, pcsc, carry, config.lam, em_scale, config.gap_tol, t0, y,
                             steps=c, loss=config.loss, private=private, early_stop=True)

    carry, outs, stop_step, stop_reason = drive_chunks(
        advance, carry0, steps=config.steps, chunk=resolve_chunk(config),
        max_seconds=config.max_seconds, done_of=lambda cy: cy.done,
        stop_at_of=lambda cy: cy.stop_at)
    gaps, coords = assemble_outputs(outs, config.steps, (0.0, -1))
    return FWResult(w=carry.w * carry.w_m, gaps=gaps, coords=coords,
                    losses=torch.zeros_like(gaps), stop_step=stop_step,
                    stop_reason=stop_reason)


def torch_sparse_fw(pcsr: PaddedCSR, pcsc: ColumnLayout, y: torch.Tensor,
                    config: FWConfig, setup=None) -> FWResult:
    """One solve through the kernels: fixed T in one chunk, or the chunked
    chunk loop when the config can stop early — the same arithmetic per step,
    so the iterates agree bit for bit at every prefix.

    ``setup`` injects a precomputed (v̄₀, q̄₀, α₀), which must be what
    ``fw_setup`` would compute for (X, y, loss).
    """
    n, _ = pcsr.shape
    private = config.queue == "two_level"
    em_scale = em_scale_for(config, n)
    y_scan = None if config.loss_fn().separable else y
    if setup is None:
        setup = fw_setup(pcsr, y, loss=config.loss, pcsc=pcsc)
    if config.early_stopping:
        return _chunked_fw(pcsr, pcsc, setup, config, em_scale, private, y=y_scan)
    w, gaps, coords, _ = fw_scan(
        pcsr, pcsc, *setup, config.lam, em_scale, prng.PRNGKey(config.seed), 0.0, y_scan,
        steps=config.steps, loss=config.loss, private=private)
    return FWResult(w=w, gaps=gaps, coords=coords, losses=torch.zeros_like(gaps),
                    stop_step=config.steps, stop_reason=STOP_MAX_STEPS)
