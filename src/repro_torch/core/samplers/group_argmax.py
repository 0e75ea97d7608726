"""Lazy group-argmax queue (port of ``samplers/group_argmax.py``).

Per-group stale maxima ``bound[g]`` are upper bounds on the group's true
max |α|.  ``ga_get_next`` picks the group with the largest bound, repairs
that bound to the group's true max, and repeats until the best verified
value dominates every remaining bound — the exact argmax, with the same
staleness-dependent tie-break as the JAX ``while_loop``.

This port runs that loop on the host: each pop reads four scalars back from
the device (one synchronisation per pop).  A form without host
synchronisation is ROADMAP item A3.

Updates are increase-only: live priorities are scattered and bounds only
ratchet upward.  The coordinate-update kernel does this in place
(``ga_scatter_`` is its plain form); ``ga_update`` is the functional form
with the JAX package's signature.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

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
        return self.p.shape[1]

    def clone(self) -> "GroupArgmaxState":
        return GroupArgmaxState(self.p.clone(), self.bound.clone(), self.d, self.pops)


def ga_init(priorities: torch.Tensor) -> GroupArgmaxState:
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
    """Scatter live priorities (idx >= d dropped); bounds only ratchet upward."""
    valid = idx < state.d
    out = state.clone()
    ga_scatter_(out, idx[valid], priorities[valid])
    return out


def ga_get_next(state: GroupArgmaxState) -> Tuple[int, GroupArgmaxState]:
    """Lazy-repair argmax; returns (flat index, state with repaired bounds)."""
    bound = state.bound.clone()
    best_j, best_v = -1, _NEG_INF_F32
    pops = state.pops
    while True:
        g = torch.argmax(bound)          # first maximal index, as jnp.argmax
        row = state.p[g]
        j_in = torch.argmax(row)
        top, true_max = bound[g], row[j_in]
        top_v, true_v, g_i, j_i = torch.stack(
            [top.double(), true_max.double(), g.double(), j_in.double()]).tolist()
        if not top_v > best_v:
            break
        pops += 1
        bound[g] = true_max  # repair: bound → truth
        if true_v > best_v:
            best_j, best_v = int(g_i) * state.group_size + int(j_i), true_v
    return best_j, GroupArgmaxState(p=state.p, bound=bound, d=state.d, pops=pops)
