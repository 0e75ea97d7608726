"""Two-level exponential-mechanism sampler state (port of ``samplers/bsls_jax.py``).

P(j) ∝ exp(v_j) is sampled as P(group g)·P(j | g): one Gumbel-max over the
``G = ⌈√D⌉`` group log-sum-exps ``c`` (big step) and one over the
``M = ⌈D/G⌉`` members of the chosen group (little step).  The draw itself is
the ``two_level_draw`` kernel (``kernels/bsls_draw``); this module holds the
state and its updates.

Updates after a Frank-Wolfe step scatter the touched coordinates' new
log-weights and rebuild the touched groups' log-sum-exps exactly (the JAX
package recomputes all G sums and keeps the touched ones).  The solver
splits an update in two: the coordinate-update kernel scatters ``v`` and
raises ``touched`` in place (``tl_scatter_`` is its plain form), then the
next step's draw launch rebuilds the touched groups' ``c`` before it draws;
``tl_rebuild_`` rebuilds alone (after a chunk's last step).  ``tl_update``
is the functional form of both, with the JAX package's signature and its
treatment of dropped entries (``torch_dense``'s step runs it).

Stacked state (a sweep group's lanes): ``tl_init`` on a (B, D) matrix of
log-weights gives ``v`` (B, G, M), ``c`` (B, G) and ``touched`` (B, G), each
lane initialised as the single-config state is; ``lane(b)`` is lane b's
state as views into the stacked tensors, and ``tl_rebuild_`` rebuilds every
lane in one launch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import prng

NEG_INF = -1e30


@dataclasses.dataclass
class TwoLevelSamplerState:
    v: torch.Tensor        # (G, M) log-weights, padded with NEG_INF
    c: torch.Tensor        # (G,)   per-group log-sum-exp
    d: int                 # true number of items
    touched: torch.Tensor  # (G,)   int32 groups scattered since the last rebuild

    @property
    def group_size(self) -> int:
        return self.v.shape[-1]

    @property
    def lanes(self) -> Optional[int]:
        """B of a stacked state; None for one config."""
        return self.v.shape[0] if self.v.dim() == 3 else None

    def lane(self, b: int) -> "TwoLevelSamplerState":
        """Lane b of a stacked state, as views (updates write through)."""
        return TwoLevelSamplerState(self.v[b], self.c[b], self.d, self.touched[b])

    def clone(self) -> "TwoLevelSamplerState":
        return TwoLevelSamplerState(self.v.clone(), self.c.clone(), self.d,
                                    self.touched.clone())

    def to(self, device) -> "TwoLevelSamplerState":
        return TwoLevelSamplerState(self.v.to(device), self.c.to(device), self.d,
                                    self.touched.to(device))


def _group_shape(d: int) -> Tuple[int, int]:
    g = max(1, math.isqrt(max(d - 1, 0)) + 1)  # ⌈√D⌉ groups
    m = (d + g - 1) // g
    return g, m


def logsumexp_rows(v: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp written as ``jax.scipy.special.logsumexp`` computes it."""
    amax = v.amax(dim=1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log(torch.exp(v - amax).sum(dim=1)) + amax[:, 0]


def tl_init(log_weights: torch.Tensor) -> TwoLevelSamplerState:
    """State of the (D,) log-weights, or stacked state of (B, D) ones."""
    if log_weights.dim() == 2:
        lanes = [tl_init(row) for row in log_weights]
        return TwoLevelSamplerState(v=torch.stack([s.v for s in lanes]),
                                    c=torch.stack([s.c for s in lanes]), d=lanes[0].d,
                                    touched=torch.stack([s.touched for s in lanes]))
    d = log_weights.shape[0]
    g, m = _group_shape(d)
    v = torch.full((g * m,), NEG_INF, dtype=log_weights.dtype, device=log_weights.device)
    v[:d] = log_weights
    v = v.reshape(g, m)
    return TwoLevelSamplerState(v=v, c=logsumexp_rows(v), d=d,
                                touched=torch.zeros(g, dtype=torch.int32, device=v.device))


def tl_sample(state: TwoLevelSamplerState, key) -> torch.Tensor:
    """Draw j ~ softmax(v) via group-then-member Gumbel-max.  O(G + M)."""
    kg, km = prng.split(key)
    dev = state.v.device
    g = torch.argmax(state.c + prng.gumbel(kg, state.c.shape, dev))
    row = state.v[g]
    j_in = torch.argmax(row + prng.gumbel(km, row.shape, dev))
    return g * state.group_size + j_in


def tl_scatter_(state: TwoLevelSamplerState, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """In place: ``v[idx] = vals`` and mark the groups of ``idx`` touched
    (every ``idx`` must be < d)."""
    idx = idx.long()
    state.v.view(-1)[idx] = vals
    state.touched[idx // state.group_size] = 1


def rebuild_groups_(c: torch.Tensor, v: torch.Tensor, touched: torch.Tensor) -> None:
    """In place, plain ops: recompute every group's log-sum-exp, keep the
    touched ones in ``c``, clear ``touched``."""
    c.copy_(torch.where(touched.bool(), logsumexp_rows(v), c))
    touched.zero_()


def tl_rebuild_(state: TwoLevelSamplerState) -> None:
    """In place: rebuild the touched groups' log-sum-exps and clear their
    flags (a CUDA state launches the draw kernel's rebuild-only form, one
    launch for every lane of a stacked state)."""
    if state.v.device.type == "cpu":
        for lane in [state.lane(b) for b in range(state.lanes)] if state.lanes else [state]:
            rebuild_groups_(lane.c, lane.v, lane.touched)
        return
    # imported here: the kernels' modules import this one
    from repro_torch.kernels.bsls_draw.ops import rebuild_touched
    rebuild_touched(state.c, state.v, state.touched)


def tl_update(state: TwoLevelSamplerState, idx: torch.Tensor,
              new_log_weights: torch.Tensor) -> TwoLevelSamplerState:
    """Scatter new log-weights for ``idx`` and rebuild the affected group
    sums exactly.  An entry with idx >= d is dropped as the JAX package drops
    it: it rewrites ``v[0]``'s current value and marks no group.  No boolean
    mask, so a CUDA state is updated without a host synchronisation."""
    out = state.clone()
    idx = idx.long()
    valid = idx < out.d
    safe = torch.where(valid, idx, 0)
    flat = out.v.view(-1)
    flat[safe] = torch.where(valid, new_log_weights, flat[safe])
    out.touched.scatter_reduce_(0, safe // out.group_size, valid.to(out.touched.dtype),
                                reduce="amax")
    tl_rebuild_(out)
    return out
