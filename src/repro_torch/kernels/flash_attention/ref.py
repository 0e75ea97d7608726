"""Materialised attention, the oracle of the flash-attention tests.

Copy of ``repro/kernels/flash_attention/ref.py``: O(S²) memory, test sizes
only.  GQA layout as ``models/flash.py``: q (B, Sq, H, hd), k/v
(B, Sk, KV, hd) with H = KV·G query heads per kv head.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qf = q.float().reshape(b, sq, kv, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, -1).to(q.dtype)
