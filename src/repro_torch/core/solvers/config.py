"""Solver configuration and result types of the port (``repro.core.solvers.config``).

``FWConfig`` keeps the JAX package's fields so one config reads the same in
both packages; ``interpret`` gives way to ``device`` (``"cuda"`` by
default).  Fields whose feature this slice of the port does not implement
are refused by ``check_supported`` with the ``ROADMAP.md`` item that adds
them, never ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.losses import Objective, get_loss

# FWResult.stop_reason values:
STOP_MAX_STEPS = "max_steps"      # ran the full T iterations
STOP_GAP_TOL = "gap_tol"          # duality-gap certificate reached gap_tol
STOP_MAX_SECONDS = "max_seconds"  # wall-clock budget exhausted


@dataclasses.dataclass(frozen=True)
class FWConfig:
    """One Frank-Wolfe run, declaratively (see ``repro.core.solvers.config``)."""

    backend: str = "dense"       # dense | torch_dense | host_sparse | torch_sparse | jax_shard
    lam: float = 50.0            # L1 radius λ
    steps: int = 4000            # T
    loss: str = "logistic"
    selection: str = "argmax"    # Alg-1 rule: argmax | noisy_max | gumbel
    queue: Optional[str] = None  # Alg-2 rule; None → backend non-private default
    epsilon: float = 1.0
    delta: float = 1e-6
    seed: int = 0
    device: str = "cuda"         # where the solve runs; "cpu" runs the plain versions
    # jax_shard only: (row shards, feature shards) of the rank grid
    mesh: Optional[Tuple[int, int]] = None
    gap_tol: float = 0.0
    max_seconds: Optional[float] = None
    chunk_steps: Optional[int] = None
    screen_every: int = 0
    screen_eps_frac: float = 0.25
    lambdas: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.lambdas is not None:
            object.__setattr__(self, "lambdas", tuple(float(l) for l in self.lambdas))

    def loss_fn(self) -> Objective:
        return get_loss(self.loss)

    @property
    def early_stopping(self) -> bool:
        """True when this config can stop before ``steps`` iterations."""
        return self.gap_tol > 0.0 or self.max_seconds is not None


# field → (is it set?, the ROADMAP.md item that implements it); every field
# of the JAX package's FWConfig is ported
_UNSUPPORTED = ()


def check_supported(config: FWConfig) -> None:
    """Refuse config fields this slice of the port does not implement."""
    for field, is_set, item in _UNSUPPORTED:
        if is_set(config):
            raise NotImplementedError(
                f"FWConfig.{field}={getattr(config, field)!r} is not ported yet: "
                f"see ROADMAP.md item {item}")


def check_gap_certificate(config: FWConfig) -> None:
    """Refuse ``gap_tol`` stopping when the objective cannot certify it
    (non-smooth loss); also surfaces unknown loss names (``KeyError``)."""
    obj = config.loss_fn()
    if config.gap_tol > 0.0 and not obj.smooth:
        note = obj.curvature_note or "no curvature bound"
        raise ValueError(
            f"loss {config.loss!r} is not smooth ({note}): the FW gap "
            "certificate is invalid, so gap_tol early stopping is unavailable")


@dataclasses.dataclass
class FWResult:
    w: torch.Tensor          # final iterate (D,)
    gaps: torch.Tensor       # FW gap g_t per iteration (T,)
    coords: torch.Tensor     # selected coordinate per iteration (T,)
    losses: torch.Tensor     # mean loss per iteration (T,); zeros if untracked
    stop_step: Optional[Union[int, torch.Tensor]] = None
    stop_reason: str = STOP_MAX_STEPS

    @property
    def nnz(self) -> torch.Tensor:
        return torch.sum(self.w != 0)

    def stop_step_or(self, default: Optional[int] = None) -> int:
        """``stop_step`` as a Python int; falls back to len(gaps)."""
        if self.stop_step is None:
            return int(default if default is not None else self.gaps.shape[0])
        return int(self.stop_step)

    @property
    def gaps_valid(self) -> torch.Tensor:
        return self.gaps[: self.stop_step_or()]

    @property
    def coords_valid(self) -> torch.Tensor:
        return self.coords[: self.stop_step_or()]
