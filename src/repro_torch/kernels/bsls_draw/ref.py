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
