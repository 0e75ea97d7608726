"""Algorithm 2 — Fast Sparse-Aware Frank-Wolfe (faithful host implementation).
(The port's copy of ``repro.core.fw_sparse``: numpy float64 on the host,
verbatim apart from its imports; the ``host_sparse`` backend runs it.)

Line-for-line realization of the paper's Algorithm 2 over exact HostCSR /
HostCSC, with the queue abstraction of line 6 pluggable:

  * ``FibHeapQueue``   (Alg 3)  → non-private, deterministic
  * ``BSLSSampler``    (Alg 4)  → DP exponential mechanism, O(√D log D)/draw
  * ``NoisyMaxQueue``            → DP ablation (sparse updates, O(D) select)
  * ``ExactArgmaxQueue``         → non-private ablation

State (paper notation): stored weights ``w̃`` with multiplicative scale
``w_m`` (true iterate = w_m·w̃), row scores ``v̄`` (true = w_m·v̄), row
gradient parts ``q̄ = h(w_m·v̄)``, column gradients ``α = (Xᵀ(q̄) − ȳ)/N``
(mean-normalized, matching fw_dense), FW gap accumulator ``g̃ = ⟨α, w_true⟩``.

Pseudocode typos fixed (recorded per DESIGN.md):
  * line 20 is ``w̃⁽ʲ⁾ += η·d̃/w_m`` (after the w_m update of line 19);
  * line 24's ``q̄⁽ʲ⁾`` is the *row* entry ``q̄⁽ⁱ⁾``.

Every floating-point operation on data-shaped values is counted in ``flops``
so Fig. 2/4 can be reproduced exactly.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from repro_torch.core.dp.accountant import fw_noise_scale, per_step_epsilon
from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.base import ExactArgmaxQueue, NoisyMaxQueue
from repro_torch.core.samplers.bsls import BSLSSampler
from repro_torch.core.samplers.fib_heap import FibHeapQueue
from repro_torch.core.sparse.formats import HostCSC, HostCSR


def _row_grad_np(loss_name: str, y: np.ndarray):
    """float64 per-row gradient map over row subsets: ``h(m, rows)``.

    Separable objectives ignore the rows (``h(m) = split_grad(m)``); the
    label-coupled ones gather their labels (``grad(m, y[rows])``).  ``rows``
    may be an index array or a scalar row id.
    """
    obj = get_loss(loss_name)
    if obj.separable:
        h_np = obj.split_grad_np
        if h_np is None:
            raise ValueError(f"loss {loss_name!r} has no numpy twin")
        return lambda m, rows: h_np(m)
    g_np = obj.grad_np
    if g_np is None:
        raise ValueError(f"loss {loss_name!r} has no numpy twin")
    return lambda m, rows: g_np(m, y[rows])


@dataclasses.dataclass
class SparseFWResult:
    w: np.ndarray
    gaps: np.ndarray
    coords: np.ndarray
    flops: int
    queue_work: int
    pops: Optional[int] = None   # FibHeap Fig-3 accounting
    # §9 gap-adaptive stopping: iterations actually applied + why the loop
    # ended (max_steps | gap_tol | max_seconds).  gaps/coords keep length T
    # with 0.0 / -1 sentinels past stop_step, matching the device scans.
    stop_step: Optional[int] = None
    stop_reason: str = "max_steps"

    @property
    def nnz(self) -> int:
        return int(np.sum(self.w != 0))


def sparse_fw(
    X_csr: HostCSR,
    y: np.ndarray,
    *,
    lam: float = 50.0,
    steps: int = 4000,
    loss: str = "logistic",
    queue: str = "fib_heap",       # fib_heap | bsls | noisy_max | argmax
    epsilon: float = 1.0,
    delta: float = 1e-6,
    seed: int = 0,
    X_csc: Optional[HostCSC] = None,
    fast: bool = True,             # vectorized inner loop (identical math);
                                   # False = paper-line-by-line per-row path
    gap_tol: float = 0.0,          # §9: stop once g_t ≤ gap_tol (0 = never)
    max_seconds: Optional[float] = None,  # §9: wall-clock budget
) -> SparseFWResult:
    n, d = X_csr.shape
    y = np.asarray(y)
    h = _row_grad_np(loss, y)
    loss_obj = get_loss(loss)
    csc = X_csc if X_csc is not None else X_csr.tocsc()
    flops = 0

    # --- DP scaling (paper Alg 2 line 5, derived per core/dp/accountant.py) --
    private = queue in ("bsls", "noisy_max")
    if private:
        eps_step = per_step_epsilon(epsilon, delta, steps)
        em_scale = eps_step * n / (2.0 * loss_obj.lipschitz)   # logits per |α|
        lap_b = fw_noise_scale(epsilon=epsilon, delta=delta, steps=steps,
                               lam=lam, lipschitz=loss_obj.lipschitz, n_rows=n)
    else:
        em_scale, lap_b = 0.0, 0.0

    # --- state ---------------------------------------------------------------
    w = np.zeros(d)            # stored w̃
    w_m = 1.0
    g_tilde = 0.0
    ybar = X_csr.rmatvec(y) / n
    flops += 2 * X_csr.nnz + d

    vbar = np.zeros(n)         # stored v̄ (true = w_m·v̄)
    qbar = h(np.zeros(n), slice(None))   # q̄ = h(0) at w = 0
    z0 = X_csr.rmatvec(qbar) / n
    # separable: α = Xᵀq̄/N − ȳ; label-coupled: q̄ already carries the label
    alpha = z0 - ybar if loss_obj.separable else z0
    flops += 2 * X_csr.nnz + n + 2 * d

    # --- queue ----------------------------------------------------------------
    if queue == "fib_heap":
        Q = FibHeapQueue(d, magnitude=lambda j: abs(alpha[j]))
        Q.add_all(np.abs(alpha))
    elif queue == "argmax":
        Q = ExactArgmaxQueue(d)
        Q.add_all(np.abs(alpha))
    elif queue == "noisy_max":
        Q = NoisyMaxQueue(d, noise_scale=lap_b / lam, seed=seed)  # |α| units
        Q.add_all(np.abs(alpha))
    elif queue == "bsls":
        Q = BSLSSampler(np.abs(alpha) * em_scale, seed=seed)
    else:
        raise ValueError(f"unknown queue {queue!r}")

    gaps = np.zeros(steps)
    coords = np.zeros(steps, dtype=np.int64)

    indptr, indices, data = X_csr.indptr, X_csr.indices, X_csr.data
    scale = em_scale if private else 1.0

    stop_step, stop_reason = steps, "max_steps"
    t_start = time.perf_counter()
    for t in range(1, steps + 1):
        # line 15: select coordinate
        if queue == "bsls":
            j = Q.sample_fast() if fast else Q.sample()
        else:
            j = Q.get_next()
        # lines 16-17: direction coordinate and gap
        d_tilde = -lam * np.sign(alpha[j]) if alpha[j] != 0 else lam
        g_t = g_tilde - d_tilde * alpha[j]
        gaps[t - 1] = g_t
        coords[t - 1] = j
        # lines 18-21: scale update + single-coordinate write
        eta = 2.0 / (t + 2.0)
        w_m *= (1.0 - eta)
        w[j] += eta * d_tilde / w_m
        g_tilde = g_tilde * (1.0 - eta) + eta * d_tilde * alpha[j]
        flops += 8
        # lines 22-28: propagate through rows holding feature j
        rows, xvals = csc.col(j)
        if fast:
            # vectorized over the column's rows — identical arithmetic to the
            # per-row loop below (rows are unique; α adds commute), the per-
            # element work moved from the interpreter to the vector unit.
            vbar[rows] += eta * d_tilde * xvals / w_m            # line 23
            gamma = h(w_m * vbar[rows], rows) - qbar[rows]       # line 24
            qbar[rows] += gamma                                  # line 25
            starts, ends = indptr[rows], indptr[rows + 1]
            sizes = (ends - starts).astype(np.int64)
            total = int(sizes.sum())
            if total:
                # ragged gather: flat positions of every touched row's nnz
                seg0 = np.repeat(starts - np.concatenate(
                    ([0], np.cumsum(sizes)[:-1])), sizes)
                flat = seg0 + np.arange(total)
                cols_f = indices[flat]
                contrib = np.repeat(gamma / n, sizes) * data[flat]
                np.add.at(alpha, cols_f, contrib)                # line 26
                g_tilde += w_m * float(contrib @ w[cols_f])      # line 27
                touched_idx = np.unique(cols_f)
                Q.update_batch(touched_idx,
                               np.abs(alpha[touched_idx]) * scale)  # line 29
            flops += 6 * rows.shape[0] + 4 * total
        else:
            touched: dict = {}
            for i_idx in range(rows.shape[0]):
                i = rows[i_idx]
                x_ij = xvals[i_idx]
                vbar[i] += eta * d_tilde * x_ij / w_m          # line 23
                gamma = h(w_m * vbar[i], i) - qbar[i]          # line 24 (q̄⁽ⁱ⁾)
                qbar[i] += gamma                               # line 25
                r_idx, r_val = X_csr.row(i)
                contrib = (gamma / n) * r_val
                alpha[r_idx] += contrib                        # line 26
                g_tilde += (gamma / n) * float(r_val @ w[r_idx]) * w_m  # line 27
                flops += 6 + 4 * r_idx.shape[0]
                for jj in r_idx:
                    touched[int(jj)] = None
            # line 29: push refreshed priorities for every gradient updated
            for k in touched:
                Q.update(k, abs(alpha[k]) * scale)

        # ---- §9 early stopping: the certificate-producing step t stays
        # applied; the break matches the device scans' masked freeze exactly.
        # The comparison is made at float32 — the precision of the reported
        # gap trace and of the device engines — so the stopping decision is
        # a pure function of the gaps a caller can observe.
        if gap_tol > 0 and np.float32(g_t) <= np.float32(gap_tol):
            stop_step, stop_reason = t, "gap_tol"
            break
        if max_seconds is not None and time.perf_counter() - t_start >= max_seconds:
            stop_step, stop_reason = t, "max_seconds"
            break

    if stop_step < steps:
        coords[stop_step:] = -1        # sentinel, matching the device scans

    w_true = w * w_m
    pops = Q.pops if isinstance(Q, FibHeapQueue) else None
    return SparseFWResult(
        w=w_true, gaps=gaps, coords=coords, flops=flops,
        queue_work=getattr(Q, "work", 0) or getattr(Q, "items_scanned", 0),
        pops=pops, stop_step=stop_step, stop_reason=stop_reason,
    )


def sparse_fw_flops_estimate(n: int, d: int, nnz: int, steps: int,
                             s_r: float, s_c: float, w_nnz: int) -> int:
    """Analytic complexity of Alg 2+3: O(N·S_c + T‖w*‖₀log D + T·S_r·S_c)."""
    setup = 4 * nnz
    per_iter = int(s_r * (6 + 4 * s_c)) + int(3 * w_nnz * math.log2(max(d, 2)))
    return setup + steps * per_iter
