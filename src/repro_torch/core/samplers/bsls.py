"""Algorithm 4 — the Big-Step Little-Step exponential-mechanism sampler.
(The port's copy of ``repro.core.samplers.bsls``: numpy, verbatim, with
the JAX package's seeds and generators.)

Draws ``j ~ P(j) ∝ exp(v_j)`` over D fixed items (v = EM log-weights,
i.e. ε'·score/(2Δu)) in ``O(√D log D)`` expected time per draw with ``O(1)``
weight updates, by running the A-ExpJ weighted-reservoir walk of Efraimidis &
Spirakis over the item stream and skipping whole groups whose total mass lies
below the current jump target ("big steps"), descending to items only inside
the group where the jump lands ("little steps").

All state is log-scale (paper §3.3): per-group log-sum-exps ``c`` and the
global log-sum ``z_Σ``; every exponentiation subtracts ``z_Σ`` (log-sum-exp
trick) so weights live in (0, 1].  Incremental O(1) updates can suffer
catastrophic cancellation when a group's dominant item shrinks, so — as a
production hardening the paper's Java artifact handles implicitly via exact
recomputation thresholds — each group tracks an error budget and is rebuilt
exactly when it degrades (counted in ``rebuilds``; amortized O(1)).

The sampler is *law-exact*: A-ExpJ's single-reservoir walk returns an index
with probability exactly proportional to its weight, and group skipping only
changes the order in which cumulative mass is accounted, not the crossing
point.  Validated against ``exponential_mechanism_probs`` by chi-square in
tests/test_samplers.py.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

_TINY = 1e-15  # paper footnote 4: floor so every item keeps a nonzero chance


class BSLSSampler:
    """Big-Step Little-Step sampler over fixed log-weights.

    Args:
      log_weights: (D,) initial log-scale priorities (EM logits).
      seed: RNG seed.
      group_size: members per group; default ⌈√D⌉ (paper: √D groups of √D).
    """

    def __init__(self, log_weights: np.ndarray, seed: int = 0, group_size: Optional[int] = None):
        v = np.asarray(log_weights, dtype=np.float64).copy()
        self.d = v.shape[0]
        self.m = int(group_size or max(1, math.isqrt(self.d - 1) + 1))  # ⌈√D⌉
        self.g = (self.d + self.m - 1) // self.m
        # pad to full groups with -inf (zero weight)
        pad = self.g * self.m - self.d
        if pad:
            v = np.concatenate([v, np.full(pad, -np.inf)])
        self.v = v
        self.rng = np.random.default_rng(seed)
        self.c = np.empty(self.g)           # per-group log-sum-exp
        self.z = 0.0                        # global log-sum-exp z_Σ
        self._err = np.zeros(self.g)        # cancellation budget per group
        self.rebuilds = 0
        self.items_scanned = 0              # little-step cost counter
        self.groups_stepped = 0             # big-step cost counter
        self.draws = 0
        self._rebuild_all()

    # -- log-sum-exp maintenance ----------------------------------------------
    def _group_lse(self, k: int) -> float:
        seg = self.v[k * self.m : (k + 1) * self.m]
        hi = np.max(seg)
        if not np.isfinite(hi):
            return -np.inf
        return hi + math.log(np.sum(np.exp(seg - hi)))

    def _rebuild_all(self) -> None:
        for k in range(self.g):
            self.c[k] = self._group_lse(k)
        finite = self.c[np.isfinite(self.c)]
        hi = np.max(finite)
        self.z = hi + math.log(np.sum(np.exp(finite - hi)))
        self._err[:] = 0.0

    def _rebuild_group(self, k: int) -> None:
        self.rebuilds += 1
        old = self.c[k]
        self.c[k] = self._group_lse(k)
        self._err[k] = 0.0
        # refresh z from group sums (O(√D)); keeps z consistent with c
        finite = self.c[np.isfinite(self.c)]
        hi = np.max(finite)
        self.z = hi + math.log(np.sum(np.exp(finite - hi)))
        del old

    def update(self, i: int, new_log_weight: float) -> None:
        """O(1) amortized: log-scale add/subtract on the group and global sums
        (paper Alg 4 lines 31-36)."""
        if not (0 <= i < self.d):
            raise IndexError(i)
        v_cur = self.v[i]
        v_new = float(new_log_weight)
        if v_new == v_cur:
            return
        self.v[i] = v_new
        k = i // self.m
        ck = self.c[k]
        if not np.isfinite(ck):
            # group previously empty-weight; new value defines it
            self._rebuild_group(k)
            return
        # c_k' = log( exp(c_k) - exp(v_cur) + exp(v_new) )  at c_k scale
        delta = -_safe_exp(v_cur - ck) + _safe_exp(v_new - ck)
        arg = 1.0 + delta
        self._err[k] += abs(delta)
        if arg <= 1e-9 or self._err[k] > 1e6:
            self._rebuild_group(k)
            return
        dck = math.log(arg)
        self.c[k] = ck + dck
        # z update with the same trick
        dz = -_safe_exp(v_cur - self.z) + _safe_exp(v_new - self.z)
        argz = 1.0 + dz
        if argz <= 1e-9:
            self._rebuild_all()
            self.rebuilds += 1
            return
        self.z = self.z + math.log(argz)

    # -- sampling ---------------------------------------------------------------
    def sample(self) -> int:
        """One A-ExpJ pass over the D items with group skipping.

        Weights w_i = exp(v_i - z_Σ) ∈ (0,1], Σ w_i = 1 (up to drift).  The
        walk keeps a current winner ``j`` with threshold key ``T_w`` and an
        exponential jump ``X_w`` of cumulative weight to skip before the next
        winner change; groups whose remaining mass < X_w are skipped whole.
        """
        self.draws += 1
        rng = self.rng
        v, c, z, m = self.v, self.c, self.z, self.m

        def w_item(i: int) -> float:
            return max(_safe_exp(v[i] - z), _TINY)

        def w_group(k: int) -> float:
            return _safe_exp(c[k] - z)

        # initialize with item 0 (paper lines 2-5)
        j = 0
        log_tw = math.log(rng.uniform(1e-300, 1.0)) / w_item(0)  # log T_w = log(U)/w_0
        i = 1                     # stream position (next unvisited item)
        o = w_item(0)             # offset: mass already consumed in group 0
        x_w = math.log(rng.uniform(1e-300, 1.0)) / log_tw  # jump mass (>0)

        while i < self.d:
            k = i // m
            in_group_pos = i - k * m
            # mass of group k not yet visited
            if in_group_pos == 0:
                o = 0.0
            rem = w_group(k) - o
            if rem < x_w:
                # ---- Big step: skip the rest of this group (lines 8-12)
                x_w -= max(rem, 0.0)
                i = (k + 1) * m
                o = 0.0
                self.groups_stepped += 1
                continue
            # ---- Little steps inside group k (lines 13-17)
            crossed = False
            while i < min((k + 1) * m, self.d):
                wi = w_item(i)
                self.items_scanned += 1
                if wi >= x_w:
                    crossed = True
                    break
                x_w -= wi
                o += wi
                i += 1
            if not crossed:
                # group mass said the jump lands here but item walk ran past the
                # end (drift between c[k] and Σ items); treat as big step
                o = 0.0
                continue
            # new winner at position i (lines 18-27)
            j = i
            wi = w_item(i)
            o += wi
            i += 1
            # fresh threshold: T_w' = U(T_w^{w_j}, 1)^{1/w_j}   (log-scale)
            t_w = math.exp(log_tw * wi)  # = T_w^{w_j} ∈ (0,1); paper line 21
            u = rng.uniform(min(t_w, 1.0 - 1e-16), 1.0)
            log_tw = math.log(max(u, 1e-300)) / wi
            x_w = math.log(rng.uniform(1e-300, 1.0)) / log_tw
        if j >= self.d:
            j = self.d - 1
        return int(j)

    # -- vectorized fast path ---------------------------------------------------
    def sample_fast(self) -> int:
        """Two-level inverse-CDF draw — the vectorized form of the Big-Step
        Little-Step walk.  The group-mass cumsum *is* the big step (whole
        groups are skipped by `searchsorted` in one vector op); the in-group
        cumsum is the little step (one linear scan of √D items).  Same law
        (P(k) ∝ exp(c_k), P(j|k) ∝ exp(v_j − c_k)) with √D-vector work per
        draw and perfect cache behavior — the paper's insight mapped to a
        vector ISA instead of a scalar CPU walk."""
        self.draws += 1
        cw = _safe_exp_vec(self.c - self.z)
        cum = np.cumsum(cw)
        self.groups_stepped += self.g
        k = min(int(np.searchsorted(cum, self.rng.uniform(0.0, cum[-1]))),
                self.g - 1)
        seg = _safe_exp_vec(self.v[k * self.m:(k + 1) * self.m] - self.c[k])
        cum2 = np.cumsum(seg)
        self.items_scanned += self.m
        j = min(int(np.searchsorted(cum2, self.rng.uniform(0.0, cum2[-1]))),
                self.m - 1)
        return int(k * self.m + j)

    def update_batch(self, idx: np.ndarray, new_log_weights: np.ndarray) -> None:
        """Exact vectorized batch update: scatter new log-weights, rebuild the
        affected groups' log-sum-exps and the global sum — no incremental
        drift at all (stronger than the paper's O(1) updates; on a vector
        unit the segment rebuild is cheaper than scalar bookkeeping)."""
        idx = np.asarray(idx, dtype=np.int64)
        self.v[idx] = np.asarray(new_log_weights, dtype=np.float64)
        groups = np.unique(idx // self.m)
        seg = self.v.reshape(self.g, self.m)[groups]          # (Gt, m)
        hi = np.max(seg, axis=1)
        finite = np.isfinite(hi)
        out = np.full(groups.shape[0], -np.inf)
        out[finite] = hi[finite] + np.log(
            np.sum(np.exp(seg[finite] - hi[finite][:, None]), axis=1))
        self.c[groups] = out
        fin = self.c[np.isfinite(self.c)]
        top = np.max(fin)
        self.z = top + math.log(np.sum(np.exp(fin - top)))

    # -- diagnostics --------------------------------------------------------------
    def exact_probs(self) -> np.ndarray:
        vv = self.v[: self.d]
        hi = np.max(vv)
        p = np.exp(vv - hi)
        return p / p.sum()

    def cost_per_draw(self) -> float:
        if self.draws == 0:
            return 0.0
        return (self.items_scanned + self.groups_stepped) / self.draws


def _safe_exp(x: float) -> float:
    if x > 700.0:
        return math.inf
    if x < -745.0:
        return 0.0
    return math.exp(x)


def _safe_exp_vec(x: np.ndarray) -> np.ndarray:
    return np.exp(np.clip(x, -745.0, 700.0))
