"""Blockwise flash-attention forward in plain PyTorch (port of ``repro.models.flash``).

Online softmax over KV blocks, never materialising S×S: for each q block,
the visible KV blocks ``[lo, hi)`` are swept in order, carrying the running
max ``m``, normaliser ``l`` and float32 accumulator.  It is the plain
version of the hand-written kernel ``kernels/flash_attention``: the model's
attention on the CPU, and the card's yardstick in ``chip_smoke.py``.  The
JAX package's custom VJP (the blockwise backward) is not ported yet; it
comes with training (ROADMAP A13d).

GQA layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd[v]) with H = KV·G.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``scale`` is the softmax scale, ``1/sqrt(hd)`` unless given (the card's
    kernel takes zero-padded head dims with the true head dim's scale)."""
    return _flash_fwd_impl(q, k, v, causal, window, block_q, block_k, scale)


def _bounds(iq, bq, bk, nk, causal, window):
    """KV-block range [lo, hi) visible to q-block iq."""
    hi = min(((iq + 1) * bq + bk - 1) // bk, nk) if causal else nk
    lo = max((iq * bq - window + 1) // bk, 0) if window else 0
    return lo, hi


def _mask(qpos, kpos, causal, window):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _flash_fwd_impl(q, k, v, causal, window, block_q, block_k, scale=None):
    """The attention output in q's dtype (the JAX version also returns the
    log-sum-exp for its backward, which comes with training)."""
    b, sq, h, hd = q.shape
    _, sk, kv, hdk = k.shape
    hdv = v.shape[-1]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = sq // bq, sk // bk
    assert sq % bq == 0 and sk % bk == 0

    qr = q.reshape(b, nq, bq, kv, g, hd).permute(1, 0, 3, 4, 2, 5)    # (nq,B,KV,G,bq,hd)
    kr = k.reshape(b, nk, bk, kv, hdk).permute(1, 0, 3, 2, 4)         # (nk,B,KV,bk,hdk)
    vr = v.reshape(b, nk, bk, kv, hdv).permute(1, 0, 3, 2, 4)
    dev = q.device
    outs = []
    for iq in range(nq):
        qb = qr[iq].float()
        qpos = iq * bq + torch.arange(bq, device=dev)
        m = torch.full((b, kv, g, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, bq, hdv), dtype=torch.float32, device=dev)
        lo, hi = _bounds(iq, bq, bk, nk, causal, window)
        for ik in range(lo, hi):
            kpos = ik * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bkgqd,bksd->bkgqs", qb, kr[ik].float()) * scale
            s = torch.where(_mask(qpos, kpos, causal, window), s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, vr[ik].float())
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hdv).to(q.dtype)
