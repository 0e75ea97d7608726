"""Queue protocol for Frank-Wolfe coordinate selection (paper Alg 2 line 6).
(The port's copy of ``repro.core.samplers.base``: numpy, verbatim.)

A queue sees *scores* (non-negative priorities, already scaled for the DP
mechanism where applicable) and answers ``get_next()`` — the coordinate to
update.  The two brute-force queues below are the paper's ablation baselines
("Alg. 2" column of Table 3 = sparse updates + O(D) noisy-max selection).
"""
from __future__ import annotations

from typing import Iterable, Protocol, Tuple

import numpy as np


class Queue(Protocol):
    def add(self, j: int, priority: float) -> None:
        ...

    def update(self, j: int, priority: float) -> None:
        ...

    def get_next(self) -> int:
        ...

    # cost counters for the benchmark harness
    work: int


class ExactArgmaxQueue:
    """Non-private O(D) argmax over live priorities (dense baseline queue)."""

    def __init__(self, d: int):
        self.p = np.zeros(d)
        self.work = 0

    def add(self, j: int, priority: float) -> None:
        self.p[j] = priority

    def add_all(self, priorities: np.ndarray) -> None:
        self.p[:] = priorities

    def update(self, j: int, priority: float) -> None:
        self.p[j] = priority
        self.work += 1

    def get_next(self) -> int:
        self.work += self.p.shape[0]
        return int(np.argmax(self.p))


class NoisyMaxQueue:
    """Laplace report-noisy-max over live priorities — O(D) per call.

    This is the paper's "Alg. 2 (noisy-max ablation)": sparse state updates
    but brute-force private selection.  ``noise_scale`` is the Laplace b from
    ``core.dp.accountant.fw_noise_scale`` (priorities are the λ|α| scores).
    """

    def __init__(self, d: int, noise_scale: float, seed: int = 0):
        self.p = np.zeros(d)
        self.b = float(noise_scale)
        self.rng = np.random.default_rng(seed)
        self.work = 0

    def add(self, j: int, priority: float) -> None:
        self.p[j] = priority

    def add_all(self, priorities: np.ndarray) -> None:
        self.p[:] = priorities

    def update(self, j: int, priority: float) -> None:
        self.p[j] = priority
        self.work += 1

    def get_next(self) -> int:
        d = self.p.shape[0]
        self.work += d
        noise = self.rng.laplace(0.0, self.b, size=d) if self.b > 0 else 0.0
        return int(np.argmax(self.p + noise))


def batch_update(queue, updates: Iterable[Tuple[int, float]]) -> None:
    for j, v in updates:
        queue.update(j, v)


# vectorized batch updates (the host fast path in fw_sparse uses these; the
# per-item ``update`` remains for the faithful line-by-line variant)
def _dense_update_batch(self, idx: np.ndarray, priorities: np.ndarray) -> None:
    self.p[idx] = priorities
    self.work += int(idx.shape[0])


ExactArgmaxQueue.update_batch = _dense_update_batch
NoisyMaxQueue.update_batch = _dense_update_batch
