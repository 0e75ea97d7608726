"""Blockwise flash attention in plain PyTorch (port of ``repro.models.flash``).

Forward: online softmax over KV blocks, never materialising S×S: for each q
block, the visible KV blocks ``[lo, hi)`` are swept in order, carrying the
running max ``m``, normaliser ``l`` and float32 accumulator; it returns the
output and the log-sum-exp ``m + log(max(l, 1e-30))``.  Backward
(``_flash_bwd``): the JAX package's two blockwise passes, dq by q block, then
dk/dv by kv block, each recomputing P from the saved log-sum-exp.  They are
the plain versions of the hand-written kernels ``kernels/flash_attention``:
the model's attention and its gradient on the CPU, and the card's yardstick
in ``chip_smoke.py``.

GQA layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd[v]) with H = KV·G; the
log-sum-exp is (B, KV, G, Sq) float32, JAX's layout.
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
    return _flash_fwd_impl(q, k, v, causal, window, block_q, block_k, scale)[0]


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


def _blocks(sq, sk, block_q, block_k):
    bq, bk = min(block_q, sq), min(block_k, sk)
    assert sq % bq == 0 and sk % bk == 0
    return bq, bk, sq // bq, sk // bk


def _flash_fwd_impl(q, k, v, causal, window, block_q, block_k, scale=None):
    """(the attention output in q's dtype, the log-sum-exp (B, KV, G, Sq)
    float32)."""
    b, sq, h, hd = q.shape
    _, sk, kv, hdk = k.shape
    hdv = v.shape[-1]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    bq, bk, nq, nk = _blocks(sq, sk, block_q, block_k)

    qr = q.reshape(b, nq, bq, kv, g, hd).permute(1, 0, 3, 4, 2, 5)    # (nq,B,KV,G,bq,hd)
    kr = k.reshape(b, nk, bk, kv, hdk).permute(1, 0, 3, 2, 4)         # (nk,B,KV,bk,hdk)
    vr = v.reshape(b, nk, bk, kv, hdv).permute(1, 0, 3, 2, 4)
    dev = q.device
    outs, lses = [], []
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
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hdv).to(q.dtype)
    lse = torch.stack(lses).permute(1, 2, 3, 0, 4).reshape(b, kv, g, sq)
    return out, lse


def _flash_bwd(causal, window, block_q, block_k, res, dout, scale=None):
    """(dq, dk, dv) in the inputs' dtypes from ``res = (q, k, v, out, lse)``
    and ``dout``: pass 1 sweeps each q block's visible kv blocks for dq,
    pass 2 each kv block's visible q blocks (``lo_q``, ``hi_q``) for dk and
    dv; P = exp(s − lse) is recomputed in both, and ``delta = Σ dout·out``."""
    q, k, v, out, lse = res
    b, sq, h, hd = q.shape
    _, sk, kv, hdk = k.shape
    hdv = v.shape[-1]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    bq, bk, nq, nk = _blocks(sq, sk, block_q, block_k)
    dev = q.device

    qr = q.reshape(b, nq, bq, kv, g, hd).permute(1, 0, 3, 4, 2, 5).float()
    kr = k.reshape(b, nk, bk, kv, hdk).permute(1, 0, 3, 2, 4).float()
    vr = v.reshape(b, nk, bk, kv, hdv).permute(1, 0, 3, 2, 4).float()
    do = dout.reshape(b, nq, bq, kv, g, hdv).permute(1, 0, 3, 4, 2, 5).float()
    o = out.reshape(b, nq, bq, kv, g, hdv).permute(1, 0, 3, 4, 2, 5).float()
    lse_r = lse.reshape(b, kv, g, nq, bq).permute(3, 0, 1, 2, 4)       # (nq,B,KV,G,bq)
    delta = (do * o).sum(-1)                                           # (nq,B,KV,G,bq)

    def _p(iq, ik):
        qpos = iq * bq + torch.arange(bq, device=dev)
        kpos = ik * bk + torch.arange(bk, device=dev)
        s = torch.einsum("bkgqd,bksd->bkgqs", qr[iq], kr[ik]) * scale
        s = torch.where(_mask(qpos, kpos, causal, window), s, NEG)
        return torch.exp(s - lse_r[iq][..., None])

    # ---- pass 1: dq (loop q blocks; inner kv) -------------------------------
    dqs = []
    for iq in range(nq):
        lo, hi = _bounds(iq, bq, bk, nk, causal, window)
        dq = torch.zeros((b, kv, g, bq, hd), dtype=torch.float32, device=dev)
        for ik in range(lo, hi):
            p = _p(iq, ik)
            dp = torch.einsum("bkgqd,bksd->bkgqs", do[iq], vr[ik])
            ds = p * (dp - delta[iq][..., None])
            dq = dq + torch.einsum("bkgqs,bksd->bkgqd", ds, kr[ik]) * scale
        dqs.append(dq)
    dq = torch.stack(dqs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd).to(q.dtype)

    # ---- pass 2: dk, dv (loop kv blocks; inner q) ----------------------------
    dks, dvs = [], []
    for ik in range(nk):
        # q blocks that can see kv block ik
        lo_q = (ik * bk) // bq if causal else 0
        hi_q = min((ik * bk + bk + window + bq - 1) // bq, nq) if window else nq
        dk = torch.zeros((b, kv, bk, hdk), dtype=torch.float32, device=dev)
        dv = torch.zeros((b, kv, bk, hdv), dtype=torch.float32, device=dev)
        for iq in range(lo_q, hi_q):
            p = _p(iq, ik)
            dv = dv + torch.einsum("bkgqs,bkgqd->bksd", p, do[iq])
            dp = torch.einsum("bkgqd,bksd->bkgqs", do[iq], vr[ik])
            ds = p * (dp - delta[iq][..., None])
            dk = dk + torch.einsum("bkgqs,bkgqd->bksd", ds, qr[iq]) * scale
        dks.append(dk)
        dvs.append(dv)
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(b, sk, kv, hdk).to(k.dtype)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(b, sk, kv, hdv).to(v.dtype)
    return dq, dk, dv
