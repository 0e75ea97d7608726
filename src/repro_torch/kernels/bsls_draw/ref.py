"""Plain PyTorch version of the ``two_level_draw`` kernel.

With ``touched``, the plain rebuild first (``rebuild_groups_``: the touched
groups' log-sum-exps in place, their flags cleared); then ``kg, km =
split(key)``; ``g = argmax(c + gumbel(kg, (G,)))``; ``m = argmax(v[g] +
gumbel(km, (1, M)))``; returns ``g·M + m`` — the draw
``repro/kernels/bsls_draw/ops.py::two_level_draw`` makes with the same key.
With the masked run's flag ``done`` set it returns the sentinel -1 (after
the rebuild).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.samplers.two_level import rebuild_groups_


def two_level_draw_ref(c: torch.Tensor, v: torch.Tensor, key, done=None,
                       touched=None) -> torch.Tensor:
    """(1,) int32 flat index of the draw."""
    if touched is not None:
        rebuild_groups_(c, v, touched)
    if done is not None and bool(done):
        return torch.full((1,), -1, dtype=torch.int32, device=v.device)
    kg, km = prng.split(key)
    g = torch.argmax(c + prng.gumbel(kg, c.shape, c.device))
    m = torch.argmax(v[g] + prng.gumbel(km, (1, v.shape[1]), v.device)[0])
    return (g * v.shape[1] + m).to(torch.int32).reshape(1)


def two_level_draw_lanes_ref(c: torch.Tensor, v: torch.Tensor, keys: torch.Tensor, done=None,
                             touched=None) -> torch.Tensor:
    """The lane form's plain version: (B,) int32 draws, lane b's from its rows
    of ``c``/``v``/``touched`` with the key in row b of ``keys`` (an int32
    (B, 2) table of uint32 words)."""
    words = keys.cpu().numpy().view(np.uint32)
    return torch.cat([two_level_draw_ref(c[b], v[b], (int(words[b, 0]), int(words[b, 1])),
                                         None if done is None else done[b],
                                         None if touched is None else touched[b])
                      for b in range(v.shape[0])])
