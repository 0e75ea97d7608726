"""Inputs that probe ``scatter_add_ordered``'s contract, made from a seed with numpy.

Each case is ``(dst, idx, src, live)`` as numpy arrays (``live`` None: every
lane live) whose sums depend on the order of the adds: targets that repeat
by a power law, terms over 16 decades, ``-0.0`` in ``dst`` and ``src``.
``CASES`` names the edge cases (each at a size whose live lanes fit the
kernel's one-block route, 8,192, and most also above it): the tests hold
the plain version to the JAX package's ``.at[].add`` on them on the CPU,
and the kernel to the plain version on the card, as ``tools/check_scatter.py``
and ``chip_smoke.py`` do.  ``jax_indices`` gives the index array for JAX's side,
where a dead lane is an out-of-range index (dropped; JAX would wrap ``-1``
onto the last target).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]


def power_law(seed: int, n: int, k: int, dead_frac: float) -> Case:
    """k lanes onto n targets, a few targets taking most lanes; a lane is
    dead with probability ``dead_frac``."""
    g = np.random.default_rng(seed)
    idx = np.minimum((g.pareto(0.7, size=k) * 2).astype(np.int64), n - 1)
    src = (g.standard_normal(k) * 10.0 ** g.integers(-8, 8, size=k)).astype(np.float32)
    src[g.random(k) < 0.05] = -0.0
    dst = (g.standard_normal(n) * 10.0 ** g.integers(-4, 4, size=n)).astype(np.float32)
    dst[g.random(n) < 0.2] = -0.0
    live = g.random(k) >= dead_frac
    return dst, idx, src, live


def spread(seed: int, n: int, k: int, dead_frac: float) -> Case:
    """``power_law`` with its targets spread over all of [0, n), so that
    every digit of a target varies."""
    dst, idx, src, live = power_law(seed, n, k, dead_frac)
    return dst, (idx * 7919) % n, src, live


def dead_lanes_hold(value: int, k: int = 20000, seed: int = 11) -> Case:
    """Dead lanes whose index is ``value`` (``-1``, ``n`` = 300, ``2^31 -
    1``: no target), live lanes in range."""
    dst, idx, src, live = power_law(seed, 300, k, 0.4)
    idx[~live] = value
    return dst, idx, src, live


def one_hot_target(lanes: int, seed: int = 12) -> Case:
    """One target (dst ``-0.0``) takes ``lanes`` live lanes of varied terms;
    another ``-0.0`` target takes only ``-0.0`` terms, a third only dead
    lanes, and the rest a power law."""
    g = np.random.default_rng(seed)
    n, k = 64, lanes + 4096
    dst, idx, src, live = power_law(seed, n, k, 0.2)
    hot = g.permutation(k)[:lanes]
    idx[hot], live[hot] = 7, True
    idx[(idx == 8) | (idx == 9)] = 11
    dst[[7, 8, 9]] = -0.0
    zeros = np.flatnonzero(idx != 7)[:50]
    idx[zeros], src[zeros], live[zeros] = 8, -0.0, True
    idx[np.flatnonzero(~live)[:40]] = 9
    return dst, idx, src, live


def lanes_2d(lanes: int = 4, m: int = 500, width: int = 3000, seed: int = 13) -> Case:
    """``distributed/fw_shard.py``'s ``lane_scatter``: (lanes, width) lanes
    onto the flat (lanes · m) targets, lane l's indices offset by l · m."""
    g = np.random.default_rng(seed)
    dst, idx, src, live = power_law(seed, lanes * m, lanes * width, 0.3)
    idx = np.minimum(idx, m - 1).reshape(lanes, width) + np.arange(lanes)[:, None] * m
    idx[g.random(idx.shape) < 0.01] = -1          # dead lanes only (live drops them)
    live = live.reshape(lanes, width) & (idx >= 0)
    return dst, idx, src.reshape(lanes, width), live


def _int32(case: Case) -> Case:
    dst, idx, src, live = case
    return dst, idx.astype(np.int32), src, live


def _live_none(case: Case) -> Case:
    dst, idx, src, _ = case
    return dst, idx, src, None


def _all_dead(case: Case) -> Case:
    dst, idx, src, live = case
    return dst, idx, src, np.zeros_like(live)


def _no_lanes(case: Case) -> Case:
    dst, idx, src, live = case
    return dst, idx[:0], src[:0], live[:0]


CASES: Dict[str, Callable[[], Case]] = {
    "all_dead": lambda: _all_dead(power_law(20, 200, 9000, 0.5)),
    "live_none": lambda: _live_none(power_law(21, 200, 9000, 0.0)),
    "live_none_small": lambda: _live_none(power_law(22, 50, 3000, 0.0)),
    "int32": lambda: _int32(power_law(23, 1000, 40000, 0.5)),
    "int64": lambda: power_law(23, 1000, 40000, 0.5),
    "int32_small": lambda: _int32(power_law(24, 40, 5000, 0.2)),
    "dead_minus_one": lambda: dead_lanes_hold(-1),
    "dead_minus_one_small": lambda: dead_lanes_hold(-1, k=6000),
    "dead_n": lambda: dead_lanes_hold(300),
    "dead_int32_max": lambda: _int32(dead_lanes_hold(2 ** 31 - 1)),
    "one_target_70k_neg_zero": lambda: one_hot_target(70000),
    "lanes_2d": lanes_2d,
    "lanes_2d_small": lambda: lanes_2d(width=1500),
    "wide_targets": lambda: spread(26, 70000, 60000, 0.25),
    "wide_targets_small": lambda: _int32(spread(27, 100000, 7000, 0.1)),
    "k_zero": lambda: _no_lanes(power_law(25, 30, 100, 0.0)),
}


def jax_indices(idx: np.ndarray, live: Optional[np.ndarray], n: int) -> np.ndarray:
    """The index array for JAX's ``.at[idx].add``: a dead lane's index out
    of range (n + 5), so JAX drops it."""
    return idx if live is None else np.where(live, idx, n + 5).astype(idx.dtype)
