"""DP selection mechanisms of the port (``repro.core.dp.mechanisms``).

Three equivalent-in-law implementations of private argmax over scores u(j):

* ``laplace_noisy_argmax`` — report-noisy-max with Laplace noise (the paper's
  Algorithm 1 annotation; pure-DP per step).
* ``exponential_mechanism_probs`` — the exact softmax law
  P(j) ∝ exp(ε'·u(j) / (2Δu)); the oracle distribution in tests.
* ``gumbel_argmax`` — samples the exponential mechanism exactly via the
  Gumbel-max trick (argmax_j s_j + G_j with G_j ~ Gumbel(0, 1)).

Keys are the JAX package's threefry keys (``repro_torch.prng``): the same key
draws the same uniform bits, so the same key gives the same index as the JAX
functions.  The noise is drawn on the scores' device; the index comes back
as a 0-d int64 tensor there (no host read).
"""
from __future__ import annotations

import torch

from repro_torch import prng


def laplace_noisy_argmax(key, scores: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """Report-noisy-max: argmax_j scores_j + Lap(noise_scale), with the
    uniform bits of ``jax.random.uniform(key, shape, -0.5 + 1e-12, 0.5)``."""
    u = prng.uniform(key, scores.shape, minval=-0.5 + 1e-12, maxval=0.5,
                     device=scores.device)
    lap = -noise_scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())
    return torch.argmax(scores + lap)


def em_logits(scores: torch.Tensor, eps_step: float, sensitivity: float) -> torch.Tensor:
    """Log-scale weights fed to samplers: ε'·u/(2Δu)."""
    return scores * (eps_step / (2.0 * sensitivity))


def exponential_mechanism_probs(scores: torch.Tensor, eps_step: float,
                                sensitivity: float) -> torch.Tensor:
    """Exact selection probabilities of the exponential mechanism."""
    return torch.softmax(em_logits(scores, eps_step, sensitivity), dim=-1)


def gumbel_argmax(key, logits: torch.Tensor) -> torch.Tensor:
    """Exact softmax sampling via Gumbel-max; logits already scaled by ε'/(2Δu)."""
    return torch.argmax(logits + prng.gumbel(key, logits.shape, logits.device))
