"""Lazy group-argmax queue (port of ``samplers/group_argmax.py``).

Per-group stale maxima ``bound[g]`` are upper bounds on the group's true
max |α|.  ``ga_get_next`` picks the group with the largest bound, repairs
that bound to the group's true max, and repeats until the best verified
value dominates every remaining bound — the exact argmax, with the same
staleness-dependent tie-break as the JAX ``while_loop``.

This port runs that loop on the host: each pop reads four scalars back from
the device (one synchronisation per pop).  A form without host
synchronisation is ROADMAP item A3.

Stacked state (a sweep group's lanes): ``ga_init`` on a (B, D) matrix gives
``p`` (B, G, M) and ``bound`` (B, G); the queue keeps one host loop per
lane: ``lane(b)`` is lane b's state as views, and ``ga_pop_`` repairs its
bounds in place (the same pops as ``ga_get_next``).

Updates are increase-only: live priorities are scattered and bounds only
ratchet upward.  The coordinate-update kernel does this in place
(``ga_scatter_`` is its plain form); ``ga_update`` is the functional form
with the JAX package's signature.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
_NEG_INF_F32 = float(np.float32(NEG_INF))


@dataclasses.dataclass
class GroupArgmaxState:
    p: torch.Tensor      # (G, M) live priorities (|α|), padded NEG_INF
    bound: torch.Tensor  # (G,)   stale upper bounds on each group's max
    d: int
    pops: int = 0        # repair pops so far (host count; a call syncs pops + 1 times)

    @property
    def group_size(self) -> int:
        return self.p.shape[-1]

    @property
    def lanes(self) -> Optional[int]:
        """B of a stacked state; None for one config."""
        return self.p.shape[0] if self.p.dim() == 3 else None

    def lane(self, b: int) -> "GroupArgmaxState":
        """Lane b of a stacked state, as views (updates write through)."""
        return GroupArgmaxState(self.p[b], self.bound[b], self.d)

    def clone(self) -> "GroupArgmaxState":
        return GroupArgmaxState(self.p.clone(), self.bound.clone(), self.d, self.pops)

    def to(self, device) -> "GroupArgmaxState":
        return GroupArgmaxState(self.p.to(device), self.bound.to(device), self.d, self.pops)


def ga_init(priorities: torch.Tensor) -> GroupArgmaxState:
    """Queue of the (D,) priorities, or stacked queues of (B, D) ones."""
    if priorities.dim() == 2:
        lanes = [ga_init(row) for row in priorities]
        return GroupArgmaxState(p=torch.stack([s.p for s in lanes]),
                                bound=torch.stack([s.bound for s in lanes]), d=lanes[0].d)
    d = priorities.shape[0]
    g = max(1, math.isqrt(max(d - 1, 0)) + 1)
    m = (d + g - 1) // g
    p = torch.full((g * m,), NEG_INF, dtype=priorities.dtype, device=priorities.device)
    p[:d] = priorities
    p = p.reshape(g, m)
    return GroupArgmaxState(p=p, bound=p.amax(dim=1), d=d)


def ga_scatter_(state: GroupArgmaxState, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """In place: ``p[idx] = vals`` and ratchet the bounds of their groups
    (every ``idx`` must be < d)."""
    idx = idx.long()
    state.p.view(-1)[idx] = vals
    state.bound.scatter_reduce_(0, idx // state.group_size, vals, reduce="amax")


def ga_update(state: GroupArgmaxState, idx: torch.Tensor,
              priorities: torch.Tensor) -> GroupArgmaxState:
    """Scatter live priorities; bounds only ratchet upward.  An entry with
    idx >= d is dropped as the JAX package drops it (it rewrites ``p[0]``'s
    current value and raises no bound), without a boolean mask."""
    out = state.clone()
    idx = idx.long()
    valid = idx < out.d
    safe = torch.where(valid, idx, 0)
    flat = out.p.view(-1)
    vals = torch.where(valid, priorities, flat[safe])
    flat[safe] = vals
    out.bound.scatter_reduce_(0, safe // out.group_size,
                              torch.where(valid, vals, torch.full_like(vals, NEG_INF)),
                              reduce="amax")
    return out


def _repair(p: torch.Tensor, bound: torch.Tensor, group_size: int) -> Tuple[int, int]:
    """The lazy-repair loop on ``bound`` (in place); returns (flat index, pops)."""
    best_j, best_v = -1, _NEG_INF_F32
    pops = 0
    while True:
        g = torch.argmax(bound)          # first maximal index, as jnp.argmax
        row = p[g]
        j_in = torch.argmax(row)
        top, true_max = bound[g], row[j_in]
        top_v, true_v, g_i, j_i = torch.stack(
            [top.double(), true_max.double(), g.double(), j_in.double()]).tolist()
        if not top_v > best_v:
            break
        pops += 1
        bound[g] = true_max  # repair: bound → truth
        if true_v > best_v:
            best_j, best_v = int(g_i) * group_size + int(j_i), true_v
    return best_j, pops


def ga_get_next(state: GroupArgmaxState) -> Tuple[int, GroupArgmaxState]:
    """Lazy-repair argmax; returns (flat index, state with repaired bounds)."""
    bound = state.bound.clone()
    best_j, pops = _repair(state.p, bound, state.group_size)
    return best_j, GroupArgmaxState(p=state.p, bound=bound, d=state.d, pops=state.pops + pops)


def ga_pop_(state: GroupArgmaxState) -> int:
    """``ga_get_next`` in place: repairs ``state.bound`` (a lane's view into
    stacked bounds) and counts the pops on ``state``; returns the index."""
    best_j, pops = _repair(state.p, state.bound, state.group_size)
    state.pops += pops
    return best_j
