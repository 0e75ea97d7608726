"""Objectives for L1-constrained (LASSO) generalized linear models, in torch.

Counterpart of ``repro.core.losses``: the same five objectives, the same
conventions.  Labels are y ∈ {0, 1}; a row's margin is ``m = w · x``;
``value`` is the per-row loss L(m, y) and ``grad`` returns dL/dm.  Separable
objectives (logistic, squared) satisfy ``dL/dm = h(m) − y`` and carry
``split_grad = h``; label-coupled ones (lad, huber, smoothed_hinge) set
``split_grad=None`` and the engine tracks the full ``grad(m, y)``.
``lipschitz`` is the L of the DP sensitivity Δu = L·λ/N.

Each objective also carries its numpy twins and ``kernel_id``, the index of
its specialisation in ``kernels/coord_update/csrc/coord_update.cu`` (the
per-row maps there repeat the torch functions below operation for operation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Objective:
    """A scalar margin loss with its gradient, numpy twins and DP metadata."""

    name: str
    kernel_id: int
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    split_grad: Optional[Callable[[torch.Tensor], torch.Tensor]]
    lipschitz: float
    value_np: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None
    grad_np: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None
    split_grad_np: Optional[Callable[[np.ndarray], np.ndarray]] = None
    smooth: bool = True
    curvature_note: str = ""

    @property
    def separable(self) -> bool:
        """True when dL/dm = split_grad(m) − y (logistic/squared form)."""
        return self.split_grad is not None

    def h(self, margins: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The per-row map q̄ tracks: ``split_grad(m)`` for separable
        objectives, the full ``grad(m, y)`` otherwise."""
        if self.separable:
            return self.split_grad(margins)
        if labels is None:
            raise ValueError(f"objective {self.name!r} is label-coupled; h() needs labels")
        return self.grad(margins, labels)

    def mean_value(self, margins: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return torch.mean(self.value(margins, labels))


def _softplus(m):
    # log(1 + exp(m)) as jax.nn.softplus writes it: logaddexp(m, 0)
    return torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-m.abs()))


LOGISTIC = Objective(
    name="logistic", kernel_id=0,
    value=lambda m, y: _softplus(m) - y * m,
    value_np=lambda m, y: np.logaddexp(m, 0.0) - y * m,
    grad=lambda m, y: torch.sigmoid(m) - y,
    split_grad=torch.sigmoid,
    grad_np=lambda m, y: 1.0 / (1.0 + np.exp(-m)) - y,
    split_grad_np=lambda m: 1.0 / (1.0 + np.exp(-m)),
    lipschitz=1.0,
    curvature_note="Γ_L <= λ² · max_i ‖x_i‖∞² / 4 for logistic loss",
)

SQUARED = Objective(
    name="squared", kernel_id=1,
    value=lambda m, y: 0.5 * (m - y) ** 2,
    value_np=lambda m, y: 0.5 * (m - y) ** 2,
    grad=lambda m, y: m - y,
    split_grad=lambda m: m,
    grad_np=lambda m, y: m - y,
    split_grad_np=lambda m: m,
    lipschitz=1.0,
    curvature_note="Γ = λ² · max eig(XᵀX)/N for squared loss",
)

# smoothed least-absolute-deviation (pseudo-Huber), μ as in the JAX package
_LAD_MU = 0.25


def _lad_value(m, y):
    r = m - y
    return torch.sqrt(r * r + _LAD_MU * _LAD_MU) - _LAD_MU


def _lad_grad(m, y):
    r = m - y
    return r / torch.sqrt(r * r + _LAD_MU * _LAD_MU)


LAD = Objective(
    name="lad", kernel_id=2,
    value=_lad_value, grad=_lad_grad, split_grad=None,
    value_np=lambda m, y: np.sqrt((m - y) ** 2 + _LAD_MU * _LAD_MU) - _LAD_MU,
    grad_np=lambda m, y: (m - y) / np.sqrt((m - y) ** 2 + _LAD_MU * _LAD_MU),
    lipschitz=1.0,
    curvature_note="Γ <= λ²·max_i ‖x_i‖∞²/μ (pseudo-Huber second derivative ≤ 1/μ)",
)

# δ = 0.5 gives L = 0.5, so the per-loss sensitivity path is exercised
_HUBER_DELTA = 0.5


def _huber_value(m, y):
    r = m - y
    a = torch.abs(r)
    return torch.where(a <= _HUBER_DELTA, 0.5 * r * r, _HUBER_DELTA * (a - 0.5 * _HUBER_DELTA))


def _huber_value_np(m, y):
    r = m - y
    a = np.abs(r)
    return np.where(a <= _HUBER_DELTA, 0.5 * r * r, _HUBER_DELTA * (a - 0.5 * _HUBER_DELTA))


HUBER = Objective(
    name="huber", kernel_id=3,
    value=_huber_value,
    value_np=_huber_value_np,
    grad=lambda m, y: torch.clamp(m - y, -_HUBER_DELTA, _HUBER_DELTA),
    split_grad=None,
    grad_np=lambda m, y: np.clip(m - y, -_HUBER_DELTA, _HUBER_DELTA),
    lipschitz=_HUBER_DELTA,
    curvature_note="Γ <= λ²·max_i ‖x_i‖∞² (huber second derivative ≤ 1)",
)


# smoothed hinge (Rennie & Srebro 2005) on ỹ = 2y − 1 ∈ {−1, +1}
def _smoothed_hinge_value(m, y):
    z = (2.0 * y - 1.0) * m
    return torch.where(z <= 0.0, 0.5 - z, torch.where(z < 1.0, 0.5 * (1.0 - z) ** 2, 0.0))


def _smoothed_hinge_value_np(m, y):
    z = (2.0 * y - 1.0) * m
    return np.where(z <= 0.0, 0.5 - z, np.where(z < 1.0, 0.5 * (1.0 - z) ** 2, 0.0))


def _smoothed_hinge_grad(m, y):
    yt = 2.0 * y - 1.0
    z = yt * m
    dz = torch.where(z <= 0.0, -1.0, torch.where(z < 1.0, z - 1.0, 0.0))
    return yt * dz


def _smoothed_hinge_grad_np(m, y):
    yt = 2.0 * y - 1.0
    z = yt * m
    dz = np.where(z <= 0.0, -1.0, np.where(z < 1.0, z - 1.0, 0.0))
    return yt * dz


SMOOTHED_HINGE = Objective(
    name="smoothed_hinge", kernel_id=4,
    value=_smoothed_hinge_value,
    value_np=_smoothed_hinge_value_np,
    grad=_smoothed_hinge_grad, split_grad=None,
    grad_np=_smoothed_hinge_grad_np,
    lipschitz=1.0,
    curvature_note="Γ <= λ²·max_i ‖x_i‖∞² (quadratic zone second derivative = 1)",
)


OBJECTIVES = {o.name: o for o in (LOGISTIC, SQUARED, LAD, HUBER, SMOOTHED_HINGE)}


def get_loss(name: str) -> Objective:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; have {sorted(OBJECTIVES)}") from None
