"""Privacy accounting for DP Frank-Wolfe (paper §B.2).

The paper composes T exponential-mechanism (equivalently, Laplace
report-noisy-max) selections.  Each selection scores every L1-ball vertex
``s ∈ {±λ e_j}`` with ``u(j) = <s, ∇L(w; D)>`` whose sensitivity is

    Δu = L · λ / N

(L = L1-Lipschitz constant of the loss, λ = L1 radius, N = dataset rows).
Advanced composition over T steps with target (ε, δ) gives the per-step pure
budget

    ε' = ε / sqrt(8 · T · log(1/δ)).

The Laplace report-noisy-max implementation draws
``Lap(2Δu/ε') = Lap(2λL·sqrt(8T log(1/δ)) / (N·ε))`` per coordinate — the
paper's Algorithm 1 writes the equivalent
``Lap(λL·sqrt(8T log(1/δ))/(N·ε))`` on the *halved* exponent convention; we
keep scale/2 vs scale consistent through ``fw_noise_scale`` so both the dense
baseline and the BSLS sampler draw from the same mechanism.
"""
from __future__ import annotations

import dataclasses
import math


def per_step_epsilon(epsilon: float, delta: float, steps: int) -> float:
    """ε' from advanced composition: ε = 2ε'·sqrt(2T·log(1/δ))."""
    if epsilon <= 0 or not (0 < delta < 1) or steps <= 0:
        raise ValueError("need ε>0, 0<δ<1, T>0")
    return epsilon / math.sqrt(8.0 * steps * math.log(1.0 / delta))


def em_log_weight_scale(
    *, epsilon: float, delta: float, steps: int, n_rows: int, lipschitz: float
) -> float:
    """Log-weight scale of the per-step exponential mechanism: ε'·N/(2L).

    Every DP selection path scores coordinate j with ``scale · |α_j|`` where
    ``scale = ε'·N/(2L)`` (utility sensitivity L/N at per-step budget ε' from
    advanced composition).  This is the single place that formula lives:
    ``jax_sparse.em_scale_for`` (single-device two-level sampler) and the
    ``jax_shard`` distributed Gumbel-max both call it, so the (ε, δ, T) →
    scale semantics of the two engines can never drift — pinned in
    ``tests/test_jax_shard.py``.
    """
    return per_step_epsilon(epsilon, delta, steps) * n_rows / (2.0 * lipschitz)


def fw_noise_scale(
    *, epsilon: float, delta: float, steps: int, lam: float, lipschitz: float, n_rows: int
) -> float:
    """Scale b of the per-coordinate Laplace noise for report-noisy-max.

    Matches the paper's Algorithm 1 annotation:
        b = λ·L·sqrt(8·T·log(1/δ)) / (N·ε)
    which equals Δu / ε' with Δu = λL/N and ε' from advanced composition.
    """
    eps_step = per_step_epsilon(epsilon, delta, steps)
    sensitivity = lam * lipschitz / n_rows
    return sensitivity / eps_step


@dataclasses.dataclass
class PrivacyAccountant:
    """Tracks cumulative privacy spend across FW runs / restarts.

    Frameworks restart from checkpoints; the accountant is serialized with the
    training state so a resumed run cannot silently exceed its budget.
    """

    epsilon: float
    delta: float
    total_steps: int
    spent_steps: int = 0

    def __post_init__(self):
        self.per_step = per_step_epsilon(self.epsilon, self.delta, self.total_steps)

    def spend(self, steps: int = 1) -> None:
        if self.spent_steps + steps > self.total_steps:
            raise RuntimeError(
                f"privacy budget exhausted: {self.spent_steps}+{steps} > {self.total_steps}"
            )
        self.spent_steps += steps

    @property
    def remaining_steps(self) -> int:
        return self.total_steps - self.spent_steps

    def spent_epsilon(self) -> float:
        """ε consumed so far under advanced composition at the planned T."""
        if self.spent_steps == 0:
            return 0.0
        return 2.0 * self.per_step * math.sqrt(2.0 * self.spent_steps * math.log(1.0 / self.delta))

    def to_state(self) -> dict:
        return dict(
            epsilon=self.epsilon,
            delta=self.delta,
            total_steps=self.total_steps,
            spent_steps=self.spent_steps,
        )

    @classmethod
    def from_state(cls, state: dict) -> "PrivacyAccountant":
        return cls(**state)
