"""Algorithm 1 — dense-work Frank-Wolfe over the L1 ball (``repro.core.fw_dense``).

The paper's baseline: every step recomputes the margins ``v = X·w`` and the
whole gradient ``α = Xᵀq/N`` and touches ``w`` densely, so a step costs
O(nnz + D) however sparse the selected column is.

``X`` is a dense ``(N, D)`` float32 tensor or a padded pair
``(PaddedCSR, PaddedCSC | TieredCSC)``.  On a padded pair the two products
are the port's kernels, ``ell_matvec`` over the CSR and ``ell_rmatvec`` over
the column layout (their plain versions on the CPU); on a dense tensor both
stay ``torch.matmul``, as the JAX package leaves them to XLA.

The JAX ``lax.scan`` becomes a Python loop of device operations with no host
synchronisation: the selection (``argmax``, Laplace ``noisy_max``, or the
exponential mechanism as ``gumbel``) runs on the device from the port's
``prng``, whose key chain ``key, sel_t = split(key)`` is computed on the host
once per chunk.  The masked form (``gap_tol > 0``) still applies the step
that observes ``g_t <= gap_tol``; after it the carry stays as it was and the
outputs are the sentinels (0.0, -1, 0.0).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.dp.accountant import fw_noise_scale, per_step_epsilon
from repro_torch.core.solvers.config import STOP_MAX_STEPS, FWConfig, FWResult
from repro_torch.core.solvers.torch_sparse import _div, _sync
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR, TieredCSC
from repro_torch.kernels.spmv.ops import ell_matvec, ell_rmatvec

Design = Union[torch.Tensor, Tuple[PaddedCSR, Union[PaddedCSC, TieredCSC]]]
SELECTIONS = ("argmax", "noisy_max", "gumbel")


def _matvec(X: Design, w: torch.Tensor) -> torch.Tensor:
    return ell_matvec(X[0], w) if isinstance(X, tuple) else X @ w


def _rmatvec(X: Design, q: torch.Tensor) -> torch.Tensor:
    return ell_rmatvec(X[0], q, X[1]) if isinstance(X, tuple) else X.T @ q


def _shape(X: Design) -> Tuple[int, int]:
    return tuple(X[0].shape) if isinstance(X, tuple) else tuple(X.shape)


def _device(X: Design) -> torch.device:
    return X[0].device if isinstance(X, tuple) else X.device


def _eta(t_int: int) -> float:
    # 2/(t+2) in float32 from a float32 t, as the JAX step computes it
    return float(np.float32(2.0) / (np.float32(t_int) + np.float32(2.0)))


def _dense_step(X: Design, y: torch.Tensor, config: FWConfig, masked: bool):
    """One Algorithm-1 iteration as ``step(w, done, stop_at, t_int, sel_key)
    -> ((w, done, stop_at), (gap, j, mean_loss))``.

    ȳ = Xᵀy/N (separable objectives) is computed once, here.
    """
    loss = config.loss_fn()
    n, d = _shape(X)
    dev = _device(X)
    lam = config.lam
    if config.selection not in SELECTIONS:
        raise ValueError(f"unknown selection {config.selection!r}")
    if config.selection in ("noisy_max", "gumbel"):
        b = fw_noise_scale(epsilon=config.epsilon, delta=config.delta, steps=config.steps,
                           lam=lam, lipschitz=loss.lipschitz, n_rows=n)
        eps_step = per_step_epsilon(config.epsilon, config.delta, config.steps)
        # EM logits = ε'·u/(2Δu) with u = λ|α|, Δu = λL/N  →  |α|·ε'·N/(2L)
        em_scale = eps_step * n / (2.0 * loss.lipschitz)
    else:
        b, em_scale = 0.0, 0.0
    separable = loss.separable
    ybar = _div(_rmatvec(X, y), n) if separable else None
    gap_tol = torch.tensor(config.gap_tol, dtype=torch.float32, device=dev)

    def step(w, done, stop_at, t_int: int, sel_key):
        v = _matvec(X, w)                                   # O(nnz)
        if separable:
            alpha = _div(_rmatvec(X, loss.split_grad(v)), n) - ybar
        else:
            alpha = _div(_rmatvec(X, loss.grad(v, y)), n)  # O(nnz) + O(D)
        mean_loss = torch.mean(loss.value(v, y))
        score = lam * alpha.abs()
        if config.selection == "argmax":
            j = torch.argmax(score)
        elif config.selection == "noisy_max":
            u01 = prng.uniform(sel_key, (d,), minval=-0.5 + 1e-12, maxval=0.5, device=dev)
            lap = -b * torch.sign(u01) * torch.log1p(-2.0 * u01.abs())
            j = torch.argmax(score + lap)
        else:
            j = torch.argmax(alpha.abs() * em_scale + prng.gumbel(sel_key, (d,), dev))
        j = j.reshape(1)                                    # no host read of j
        s_j = -lam * torch.sign(alpha.index_select(0, j))   # LMO vertex coordinate
        d_vec = (-w).index_add_(0, j, s_j)
        gap = -torch.dot(alpha, d_vec)                      # g_t = ⟨α,w⟩ + λ|α_j|
        w_next = w + _eta(t_int) * d_vec                    # = (1-η)w + η·s
        j = j[0].to(torch.int32)
        if not masked:
            return (w_next, done, stop_at), (gap, j, mean_loss)
        newly = ~done & (gap <= gap_tol)
        out = (torch.where(done, 0.0, gap), torch.where(done, -1, j),
               torch.where(done, 0.0, mean_loss))
        return ((torch.where(done, w, w_next), done | newly,
                 torch.where(newly, t_int, stop_at)), out)

    return step


def _carry0(X: Design, d: int, config: FWConfig):
    """(w, key, done, stop_at): w, done and stop_at on X's device, the key
    as a host tensor."""
    dev = _device(X)
    return (torch.zeros(d, dtype=torch.float32, device=dev), prng.PRNGKey(config.seed),
            torch.tensor(False, device=dev), torch.tensor(0, dtype=torch.int32, device=dev))


def _dense_chunk(step, carry, t0: int, chunk: int, *, masked: bool):
    """``chunk`` iterations of ``step`` after global step ``t0``; returns
    (carry, (gaps, coords, losses)).  Masked, the key stops at the step
    that set ``done`` (read back once, at the chunk's end)."""
    w, key, done, stop_at = carry
    key_next, sel_keys = prng.key_chain(key, chunk)
    outs = []
    for i in range(chunk):
        (w, done, stop_at), out = step(w, done, stop_at, t0 + i + 1, sel_keys[i])
        outs.append(out)
    if masked and bool(done):
        ran = min(max(int(stop_at) - t0, 0), chunk)
        key_next = prng.key_chain(key, ran)[0]
    return (w, key_next, done, stop_at), tuple(torch.stack(s) for s in zip(*outs))


def dense_fw(X: Design, y: torch.Tensor, config: FWConfig) -> FWResult:
    """Run Algorithm 1 for ``config.steps`` iterations.

    Mean-normalised objective (1/N)Σ L(w·xᵢ, yᵢ); selection scores are
    λ·|α⁽ʲ⁾| with sensitivity Δu = λ·L/N.  ``gap_tol > 0`` runs the masked
    form of the same loop; ``max_seconds`` needs :func:`dense_fw_stopping`.
    """
    d = _shape(X)[1]
    masked = config.gap_tol > 0
    step = _dense_step(X, y, config, masked)
    (w, _, done, stop_at), (gaps, coords, losses) = _dense_chunk(
        step, _carry0(X, d, config), 0, config.steps, masked=masked)
    stop_step = torch.where(done, stop_at, config.steps)
    return FWResult(w=w, gaps=gaps, coords=coords, losses=losses, stop_step=stop_step,
                    stop_reason=STOP_MAX_STEPS)


def dense_fw_stopping(X: Design, y: torch.Tensor, config: FWConfig) -> FWResult:
    """Algorithm 1 with early stopping: ``drive_chunks`` advances the masked
    loop chunk by chunk until the gap certificate lands, ``max_seconds`` runs
    out or T is spent — the same per-step arithmetic as :func:`dense_fw`, so
    the stopped iterate equals the fixed-T run's prefix."""
    from repro_torch.core.solvers.stopping import (assemble_outputs, drive_chunks,
                                                   resolve_chunk)
    masked = config.gap_tol > 0
    step = _dense_step(X, y, config, masked)

    def advance(carry, t0, c):
        return _dense_chunk(step, carry, t0, c, masked=masked)

    carry, outs, stop_step, stop_reason = drive_chunks(
        advance, _carry0(X, _shape(X)[1], config), steps=config.steps,
        chunk=resolve_chunk(config), max_seconds=config.max_seconds,
        done_of=lambda cy: cy[2], stop_at_of=lambda cy: cy[3])
    gaps, coords, losses = assemble_outputs(outs, config.steps, (0.0, -1, 0.0))
    return FWResult(w=carry[0], gaps=gaps, coords=coords, losses=losses,
                    stop_step=stop_step, stop_reason=stop_reason)


def dense_fw_screened(X: Design, y: torch.Tensor, config: FWConfig) -> FWResult:
    """Algorithm 1 with DP screening between chunks.

    The chunk loop of :func:`dense_fw_stopping` over a design that lives in a
    ``stopping.ChunkGeometry``: at every ``screen_every``-th boundary α is
    computed from the current iterate on the device (``ell_matvec`` and
    ``ell_rmatvec`` on a padded pair), only |α|/N and supp(w) go to the host
    for the keep rule, and the design (both halves of a padded pair, or the
    columns of a dense tensor) and w are cut to the survivors on the device.
    The step is built again for the new design before the next chunk, so no
    step reads the old one.  The selection runs at the solve share of ε
    (``screening.solve_epsilon``); coordinates and the final w are mapped
    back to the original feature ids.
    """
    import time

    from repro_torch.core.solvers.screening import (Screener, pair_bytes, repack_dense,
                                                    solve_epsilon)
    from repro_torch.core.solvers.stopping import (ChunkGeometry, assemble_outputs,
                                                   drive_chunks, resolve_chunk)
    loss = config.loss_fn()
    n, d0 = _shape(X)
    private = config.selection in ("noisy_max", "gumbel")
    run_cfg = (dataclasses.replace(config, epsilon=solve_epsilon(config))
               if private else config)
    em_scale = (per_step_epsilon(run_cfg.epsilon, run_cfg.delta, run_cfg.steps)
                * n / (2.0 * loss.lipschitz) if private else 0.0)
    row_width = int(X[0].indices.shape[1]) if isinstance(X, tuple) else d0
    scr = Screener(config, d=d0, n_rows=n, row_width=row_width, em_scale=em_scale,
                   private=private)
    geom = ChunkGeometry(operands=(X,), d=d0, pad_row=row_width)
    masked = run_cfg.gap_tol > 0
    built = {}   # the step of the current design: {geometry version: step}

    def advance(carry, t0, c):
        if geom.version not in built:
            built.clear()
            built[geom.version] = _dense_step(geom.operands[0], y, run_cfg, masked)
        return _dense_chunk(built[geom.version], carry, t0, c, masked=masked)

    def out_map(out, t0):
        gap, j, mean_loss = out
        return gap, scr.map_coords(j), mean_loss

    def alpha_now(Xc, w):
        v = _matvec(Xc, w)
        q = loss.split_grad(v) - y if loss.separable else loss.grad(v, y)
        return _div(_rmatvec(Xc, q).abs(), n).cpu().numpy()

    def respec(carry, t0, n_chunks):
        if not scr.due(n_chunks):
            return None
        w = carry[0]
        keep = scr.screen(alpha_now(geom.operands[0], w), (w != 0).cpu().numpy())
        if keep is None:
            return None
        tw = time.perf_counter()
        X2 = repack_dense(geom.operands[0], keep)
        w2 = w.index_select(0, torch.from_numpy(np.flatnonzero(keep)).to(w.device))
        _sync(w2.device)
        repack_s = time.perf_counter() - tw
        d2 = _shape(X2)[1]
        geom.swap((X2,), d2, pad_row=int(X2[0].indices.shape[1]) if isinstance(X2, tuple)
                  else d2)
        info = scr.commit(keep, repack_seconds=repack_s, pair_bytes=pair_bytes(X2))
        return (w2, carry[1], carry[2], carry[3]), info

    carry, outs, stop_step, stop_reason = drive_chunks(
        advance, _carry0(X, d0, config), steps=config.steps, chunk=resolve_chunk(config),
        max_seconds=config.max_seconds, done_of=lambda cy: cy[2],
        stop_at_of=lambda cy: cy[3], respec=respec, out_map=out_map)
    gaps, coords, losses = assemble_outputs(outs, config.steps, (0.0, -1, 0.0))
    return FWResult(w=scr.expand(carry[0]), gaps=gaps, coords=coords, losses=losses,
                    stop_step=stop_step, stop_reason=stop_reason)


def dense_fw_flops(n: int, d: int, nnz: int, steps: int) -> int:
    """Analytic FLOP count of Algorithm 1 (paper Fig. 2/4 accounting).

    Per iteration: matvec (2·nnz) + split grad (≈4N) + rmatvec (2·nnz)
    + α assembly (D) + |α| scoring (D) + direction/gap/update (≈4D).
    """
    per_iter = 4 * nnz + 4 * n + 6 * d
    return steps * per_iter + 2 * nnz  # + one-time ȳ
