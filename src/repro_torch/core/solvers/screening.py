"""DP iterative screening between solver chunks (``repro.core.solvers.screening``).

At every ``screen_every``-th chunk boundary a screened run drops the
coordinates that can no longer matter and continues at the smaller D:

  1. **query** — the score of coordinate j is |α_j|.  A private round
     releases it through per-coordinate Laplace noise ``Lap(Δ₁/ε_round)``,
     ``Δ₁ = 2·L·Kr/N`` (a row touches at most Kr coordinates, each by at most
     2L/N); the keep decision is post-processing, so a round is ε_round-DP.
  2. **rule** — keep j iff its noisy score is within ``margin`` of the noisy
     max, ``margin = TAIL_LOG_MASS/em_scale + NOISE_SLACK·b``; supp(w) and a
     floor of max(DEFAULT_MIN_KEEP, √D₀) coordinates always survive.
  3. **repack** — the padded pair is cut to the survivors on its own device
     (pad widths shrink to the survivors' maxima), w and α are sliced, and the
     sampler is rebuilt from the live |α|.

The rule runs on the host in float64 with the JAX package's generator and
seed, so both packages keep the same coordinates when fed the same scores;
only the (D,) scores and supp(w) cross to the host, and the (D,) keep mask
back.  The repack never copies the pair to the host: a ``TieredCSC`` is
flattened for the survivors only, not for all D columns.

ε: a run planning R rounds at budget ε spends ``screen_eps_frac·ε`` on the
rounds (spread by advanced composition) and runs its selection at the rest
(``solve_epsilon``).  Non-private runs screen without noise and keep the
whole ε.  Since supp(w) survives, X_S·w_S = X·w and v̄/q̄ stay exact; what
changes is the selection domain, so a screened run equals the unscreened
run only until its first round fires.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dp.accountant import per_step_epsilon
from repro_torch.core.solvers.config import FWConfig
from repro_torch.core.sparse.formats import (PaddedCSC, PaddedCSR, TieredCSC,
                                             tiered_from_padded)

# Survivor floor: never screen below max(DEFAULT_MIN_KEEP, √D₀) coordinates.
DEFAULT_MIN_KEEP = 16
# Keep margin in Laplace scales b (P[|Lap(b)| > 4b] ≈ 1.8%).
NOISE_SLACK = 4.0
# Keep margin in EM log-weight units: a coordinate this far below the max
# carries <= e^-7 ≈ 1e-3 of the max's selection odds per draw.
TAIL_LOG_MASS = 7.0
# Non-private rule: keep scores within this fraction of the max.
NP_KEEP_FRACTION = 0.5


@dataclasses.dataclass(frozen=True)
class ScreenPlan:
    """The ε ledger of one screened run, fixed before the first iteration
    from (steps, chunk, screen_every), never from where the run stops."""

    rounds: int          # screening rounds the schedule can fire
    eps_solve: float     # budget left to the selection mechanism
    eps_screen: float    # total screening budget (0 when rounds == 0)
    eps_round: float     # per-round pure-DP budget (advanced composition)


def check_screen_config(config: FWConfig) -> None:
    """Refuse malformed screening knobs: ``screen_every`` must be >= 0 and
    the ε fraction must leave both phases a positive budget."""
    if config.screen_every < 0:
        raise ValueError(f"screen_every must be >= 0, got {config.screen_every}")
    if config.screen_every == 0:
        return
    if not 0.0 < config.screen_eps_frac < 1.0:
        raise ValueError(
            "screen_eps_frac must be in (0, 1) so both the screening "
            f"queries and the solve keep a positive ε share; got {config.screen_eps_frac}")


def screening_rounds(steps: int, chunk: int, screen_every: int) -> int:
    """Rounds the chunk schedule can fire: one per ``screen_every`` interior
    chunk boundaries (the final boundary ends the run)."""
    if screen_every <= 0:
        return 0
    n_chunks = -(-steps // max(chunk, 1))
    return max(0, (n_chunks - 1) // screen_every)


def screen_plan(config: FWConfig, *, private: bool) -> ScreenPlan:
    """Split ``config.epsilon`` between the rounds and the solve:
    ``ε_round = ε_screen/√(8R·log(1/δ))``.  Non-private runs, and schedules
    that can never fire, keep the full ε for the solve."""
    check_screen_config(config)
    from repro_torch.core.solvers.stopping import resolve_chunk
    rounds = screening_rounds(config.steps, resolve_chunk(config), config.screen_every)
    if not private or rounds == 0:
        return ScreenPlan(rounds=rounds, eps_solve=config.epsilon, eps_screen=0.0,
                          eps_round=0.0)
    eps_screen = config.epsilon * config.screen_eps_frac
    eps_solve = config.epsilon - eps_screen
    return ScreenPlan(rounds=rounds, eps_solve=eps_solve, eps_screen=eps_screen,
                      eps_round=per_step_epsilon(eps_screen, config.delta, rounds))


def solve_epsilon(config: FWConfig) -> float:
    """ε of a private screened run's selection mechanism (the full
    ``config.epsilon`` when screening is off or can never fire)."""
    if config.screen_every <= 0:
        return config.epsilon
    return screen_plan(config, private=True).eps_solve


# ---------------------------------------------------------------------------
# the repack: column-subset the padded pair on its device, exactly
# ---------------------------------------------------------------------------


def _keep_on(keep, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keep, bool), device=device)


def repack_csr(pcsr: PaddedCSR, keep) -> PaddedCSR:
    """Column-subset repack of the padded rows: the surviving live entries
    move to the front of each row in their order (a stable sort of
    ``~live``), take the compacted column ids, and the width shrinks to the
    survivors' largest row nnz; every other lane is the padding (0, 0)."""
    dev = pcsr.device
    keep_t = _keep_on(keep, dev)
    sel = torch.nonzero(keep_t).flatten()
    remap = torch.zeros(keep_t.numel(), dtype=torch.int64, device=dev)
    remap[sel] = torch.arange(sel.numel(), device=dev)
    ri = pcsr.indices.long()
    lane = torch.arange(ri.shape[1], device=dev)
    live = (lane[None, :] < pcsr.nnz[:, None]) & keep_t[ri]
    new_idx = torch.where(live, remap[ri], 0).to(torch.int32)
    new_val = torch.where(live, pcsr.values, torch.zeros((), dtype=pcsr.values.dtype,
                                                         device=dev))
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices
    rn_new = live.sum(dim=1).to(torch.int32)
    k_row = max(1, int(rn_new.max()) if rn_new.numel() else 1)
    new_idx = torch.gather(new_idx, 1, order)[:, :k_row].contiguous()
    new_val = torch.gather(new_val, 1, order)[:, :k_row].contiguous()
    return PaddedCSR(new_idx, new_val, rn_new, (pcsr.shape[0], int(sel.numel())))


def _csc_subset(pcsc: Union[PaddedCSC, TieredCSC], sel: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full (index, value, nnz) rows of the columns ``sel`` only, cut to their
    largest nnz; a tiered column is read from the tier that holds it."""
    cn = pcsc.nnz.index_select(0, sel)
    k_col = max(1, int(cn.max()) if cn.numel() else 1)
    if not isinstance(pcsc, TieredCSC):
        return (pcsc.indices[:, :k_col].index_select(0, sel),
                pcsc.values[:, :k_col].index_select(0, sel), cn)
    dev = pcsc.device
    ci = torch.zeros((sel.numel(), k_col), dtype=pcsc.indices.dtype, device=dev)
    cv = torch.zeros((sel.numel(), k_col), dtype=pcsc.values.dtype, device=dev)
    light = min(pcsc.width, k_col)
    ci[:, :light] = pcsc.indices[:, :light].index_select(0, sel)
    cv[:, :light] = pcsc.values[:, :light].index_select(0, sel)
    heavy = torch.nonzero(cn > pcsc.width).flatten()
    if heavy.numel():
        slots = pcsc.heavy_slot.index_select(0, sel.index_select(0, heavy)).long()
        ci[heavy] = pcsc.heavy_indices[:, :k_col].index_select(0, slots)
        cv[heavy] = pcsc.heavy_values[:, :k_col].index_select(0, slots)
    return ci, cv, cn


def repack_pair(pcsr: PaddedCSR, pcsc: Union[PaddedCSC, TieredCSC], keep
                ) -> Tuple[PaddedCSR, Union[PaddedCSC, TieredCSC]]:
    """Both padded layouts cut to the surviving columns, on their device.

    The CSC side is the survivors' columns cut to their largest nnz; a tiered
    input is tiered again at its light width when the survivors still exceed
    it, else it becomes the flat layout."""
    new_csr = repack_csr(pcsr, keep)
    sel = torch.nonzero(_keep_on(keep, pcsc.device)).flatten()
    ci, cv, cn = _csc_subset(pcsc, sel)
    flat = PaddedCSC(ci.to(torch.int32).contiguous(), cv.to(torch.float32).contiguous(),
                     cn.to(torch.int32).contiguous(), (pcsr.shape[0], int(sel.numel())))
    if isinstance(pcsc, TieredCSC) and pcsc.width < flat.full_width:
        return new_csr, tiered_from_padded(flat, pcsc.width)
    return new_csr, flat


def repack_dense(X, keep):
    """Column-subset an Alg 1 design: a dense (N, D) tensor, or the padded
    pair Alg 1 reads both halves of (``repack_pair``)."""
    if isinstance(X, tuple):
        return repack_pair(*X, keep)
    return X.index_select(1, torch.nonzero(_keep_on(keep, X.device)).flatten())


def repack_carry(carry, keep, em_scale: float, private: bool):
    """Column-subset a ``torch_sparse.FWCarry`` to the survivors: w and α are
    sliced, the sampler is rebuilt from the live |α| (scaled by the EM scale
    in float32, as ``fw_carry_init_lanes`` scales it), and v̄, q̄, g̃, w_m,
    the key and the stop flags stay as they are (supp(w) survives)."""
    from repro_torch.core.samplers.group_argmax import ga_init
    from repro_torch.core.samplers.two_level import tl_init
    sel = torch.nonzero(_keep_on(keep, carry.alpha.device)).flatten()
    w = carry.w.index_select(0, sel)
    alpha = carry.alpha.index_select(0, sel)
    if private:
        em = torch.tensor(float(em_scale), dtype=alpha.dtype, device=alpha.device)
        sampler = tl_init(alpha.abs() * em)
    else:
        sampler = ga_init(alpha.abs())
    return dataclasses.replace(carry, w=w, alpha=alpha, sampler=sampler)


def pair_bytes(pair) -> int:
    """Device bytes of a padded pair's (or a dense design's) tensors."""
    if isinstance(pair, torch.Tensor):
        return pair.numel() * pair.element_size()
    return sum(t.numel() * t.element_size() for layout in pair
               for t in vars(layout).values() if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the per-run orchestrator
# ---------------------------------------------------------------------------


class Screener:
    """Bookkeeping of one screened run: the DP keep rule, the map from the
    current columns to the original ones, round and ε accounting, and the
    telemetry (``screen.round`` event, ``screen.survivors`` gauge,
    ``screen.repack_seconds`` histogram, ``screen.rounds`` counter).

    The backends own what a score and a repack are for their carry; this
    class owns when a round is due, the noisy decision, and the map back to
    the original feature ids.
    """

    def __init__(self, config: FWConfig, *, d: int, n_rows: int, row_width: int,
                 em_scale: float, private: bool):
        check_screen_config(config)
        if config.screen_every <= 0:
            raise ValueError("Screener requires screen_every > 0")
        self.config = config
        self.private = bool(private)
        self.plan = screen_plan(config, private=private)
        self.d0 = int(d)
        self.sel = np.arange(self.d0, dtype=np.int64)   # current -> original
        self._sel_dev: Optional[torch.Tensor] = None    # ``sel`` on the run's device
        self.rounds_done = 0
        lipschitz = config.loss_fn().lipschitz
        # L1 sensitivity of the α release under a one-row change
        self.sensitivity = 2.0 * lipschitz * int(row_width) / max(int(n_rows), 1)
        self.noise_b = (self.sensitivity / self.plan.eps_round
                        if self.private and self.plan.rounds else 0.0)
        self.em_scale = float(em_scale)
        self.min_keep = max(DEFAULT_MIN_KEEP, math.isqrt(self.d0))

    @property
    def d_current(self) -> int:
        return int(self.sel.size)

    def due(self, n_chunks: int) -> bool:
        """Is a round due at the boundary after chunk ``n_chunks``?"""
        return (self.rounds_done < self.plan.rounds
                and n_chunks % self.config.screen_every == 0)

    def screen(self, scores: np.ndarray, support: np.ndarray) -> Optional[np.ndarray]:
        """One round over the current-space ``scores`` (|α|): the keep mask,
        or None when every coordinate survives (the round is still spent).
        ``support`` marks the coordinates that must survive (supp(w))."""
        scores = np.asarray(scores, np.float64)
        support = np.asarray(support, bool)
        d = scores.shape[0]
        if self.private:
            rng = np.random.default_rng(
                (int(self.config.seed) & 0xFFFFFFFF, self.rounds_done, 0x5C12EE))
            noisy = scores + rng.laplace(0.0, self.noise_b, d)
            margin = TAIL_LOG_MASS / max(self.em_scale, 1e-12) + NOISE_SLACK * self.noise_b
            keep = noisy >= noisy.max() - margin
        else:
            noisy = scores
            keep = scores >= NP_KEEP_FRACTION * scores.max()
        keep |= support
        floor = min(self.min_keep, d)
        if int(keep.sum()) < floor:
            # rank by the same (noisy) release: post-processing, no extra ε
            top = np.argpartition(noisy, d - floor)[d - floor:]
            keep[top] = True
        if keep.all():
            self.rounds_done += 1
            if obs.enabled():
                obs.event("screen.round", round=self.rounds_done, survivors=d, dropped=0,
                          eps_round=self.plan.eps_round, repacked=False)
            return None
        return keep

    def commit(self, keep: np.ndarray, *, repack_seconds: float, **facts) -> dict:
        """Record a fired round: fold ``keep`` into the map and emit the
        trail; ``facts`` (the new pair's bytes, its tables' build times) go
        into the ``screen.round`` event.  Returns the round's facts, which
        the chunk loop forwards to its ``chunks.respec`` event."""
        keep = np.asarray(keep, bool)
        kept = np.flatnonzero(keep)
        dropped = int(keep.size - kept.size)
        self.sel = self.sel[kept]
        self._sel_dev = None
        self.rounds_done += 1
        if obs.enabled():
            obs.event("screen.round", round=self.rounds_done, survivors=int(kept.size),
                      dropped=dropped, eps_round=self.plan.eps_round,
                      repack_seconds=round(repack_seconds, 6), repacked=True, **facts)
            obs.gauge("screen.survivors", int(kept.size))
            obs.observe("screen.repack_seconds", repack_seconds)
            obs.count("screen.rounds")
        return {"round": self.rounds_done, "survivors": int(kept.size), "dropped": dropped}

    def _sel_on(self, device) -> torch.Tensor:
        if self._sel_dev is None or self._sel_dev.device != torch.device(device):
            self._sel_dev = torch.from_numpy(self.sel).to(device)
        return self._sel_dev

    def map_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """Chunk coordinates (current space) → original feature ids on their
        device, -1 sentinels kept.  Apply with the map in force when the
        chunk ran: the chunk loop's ``out_map`` runs before the boundary's
        repack."""
        sel = self._sel_on(coords.device)
        mapped = sel[coords.long().clamp(min=0, max=max(sel.numel() - 1, 0))]
        return torch.where(coords >= 0, mapped, -1).to(torch.int32)

    def expand(self, w: torch.Tensor) -> torch.Tensor:
        """Survivor-space iterate → the original D₀-long vector (zeros on the
        screened-out coordinates, exact since supp(w) always survives)."""
        full = torch.zeros(self.d0, dtype=w.dtype, device=w.device)
        full[self._sel_on(w.device)] = w
        return full
