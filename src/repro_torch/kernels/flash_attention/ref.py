"""Materialised attention, the oracle of the flash-attention tests, the
kernels' tile schedules, and the orders of the bf16 forward and the backward.

``attention_ref`` is a copy of ``repro/kernels/flash_attention/ref.py``: O(S²)
memory, test sizes only.  GQA layout as ``models/flash.py``: q (B, Sq, H, hd),
k/v (B, Sk, KV, hd) with H = KV·G query heads per kv head.  ``visited_tiles``
walks the kernels' loops (``key_span``, ``query_span``, ``first_key_tile``:
``kernels/csrc/f32_tiles.cuh`` line for line), ``flash_fwd_bf16_plain``
computes the bf16 forward in the ``wgmma`` kernel's order and arithmetic, and
``flash_bwd_key_major_plain`` sums the backward in the float32 kernel's order.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


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


# ---- the float32 kernels' tile schedule and the backward's order -------------
#
# The loop bounds of csrc/flash_attention.cu and of flash_attention_bwd.cu's
# float32 route (kernels/csrc/f32_tiles.cuh key_span, query_span,
# first_key_tile), copied line for line, and the loops that walk them.  Used
# only by the tests.

# the kernels' tiles by padded head dim (flash_attention.cu's and
# flash_attention_bwd.cu's by_head_dim): the forward's (query rows a block, key
# rows a tile, query rows a warp), the backward's (keys an item, query rows a
# step; ops.BWD_QUERY_TILE)
FWD_TILES = {16: (128, 64, 32), 32: (128, 64, 32), 64: (128, 64, 32), 128: (128, 64, 16),
             256: (64, 32, 16)}
BWD_TILES = {16: (64, 64), 32: (64, 64), 64: (64, 64), 128: (64, 64), 256: (32, 64)}
# the bf16 forward's tiles by (hd, hdv) of ops.BF16_WIDTHS (flash_attention_wgmma.cu's
# Shape): query rows a block, keys a tile; each of a block's two consumer warpgroups
# owns BF16_FWD_WG_ROWS of its rows and visits the key tiles of its own live rows
BF16_FWD_TILES = {(64, 64): (128, 128), (128, 128): (128, 128), (192, 128): (128, 128),
                  (256, 256): (128, 64)}
BF16_FWD_WG_ROWS = 64


def key_span(q0: int, q1: int, bk: int, sk: int, causal: bool, window: int):
    """The key tiles [lo, hi) of width bk that query rows [q0, q1) visit."""
    nk = (sk + bk - 1) // bk
    hi = min((q1 + bk - 1) // bk, nk) if causal else nk
    lo = max(q0 - window + 1, 0) // bk if window else 0
    if q1 <= q0 or (window and q0 - window + 1 >= sk):
        hi = lo
    return lo, hi


def query_span(k0: int, k1: int, bm: int, sq: int, causal: bool, window: int):
    """The query tiles [t_lo, t_hi) of height bm that keys [k0, k1) visit."""
    q_begin = k0 if causal else 0
    q_end = min(sq, k1 - 1 + window) if window else sq
    t_lo = q_begin // bm
    t_hi = (q_end + bm - 1) // bm if q_end > q_begin else t_lo
    return t_lo, t_hi


def first_key_tile(t: int, bm: int, bn: int, window: int) -> int:
    """The first key tile (width bn) that visits query tile t (height bm)."""
    if not window:
        return 0
    x = t * bm - bn + 1 - window
    return 0 if x < 0 else x // bn + 1


def visited_tiles(kind: str, sq: int, sk: int, causal: bool, window: int, *, tiles: tuple,
                  groups: int = 1):
    """The tile pairs a float32 kernel computes, in its order, as
    ``(rows [q0, q1), keys [k0, k1), step)`` with the bounds cut to Sq, Sk.

    ``kind="forward"``, ``tiles=(bq, bk, warp_rows)``: each block of bq query
    rows visits the key tiles of ``key_span`` over its live rows, and each warp
    computes those of them that its own rows visit (step: the warp).
    ``kind="forward_bf16"``, ``tiles=(bq, bk)``: the bf16 ``wgmma`` forward,
    the same walk with a consumer warpgroup of ``BF16_FWD_WG_ROWS`` rows in
    place of the warp (step: the warpgroup).
    ``kind="backward"``, ``tiles=(bn, bm)``: each key tile (an item) visits
    the query tiles of ``query_span`` from the last down, its kv head's
    ``groups`` query heads inside each (step: the head)."""
    if kind == "forward_bf16":
        yield from visited_tiles("forward", sq, sk, causal, window,
                                 tiles=tuple(tiles) + (BF16_FWD_WG_ROWS,))
    elif kind == "forward":
        bq, bk, wr = tiles
        for q_lo in range(0, sq, bq):
            lo, hi = key_span(q_lo, min(q_lo + bq, sq), bk, sk, causal, window)
            for w in range(bq // wr):
                r0 = q_lo + w * wr
                r1 = min(r0 + wr, sq)
                w_lo, w_hi = key_span(r0, r1, bk, sk, causal, window)
                for it in range(lo, hi):
                    if w_lo <= it < w_hi:
                        yield (r0, r1), (it * bk, min(it * bk + bk, sk)), w
    elif kind == "backward":
        bn, bm = tiles
        for n in range((sk + bn - 1) // bn):
            k0, k1 = n * bn, min(n * bn + bn, sk)
            t_lo, t_hi = query_span(k0, k1, bm, sq, causal, window)
            for j in range((t_hi - t_lo) * groups):
                t = t_hi - 1 - j // groups
                yield (t * bm, min(t * bm + bm, sq)), (k0, k1), j % groups
    else:
        raise ValueError(f"visited_tiles: kind {kind!r}")


def flash_fwd_bf16_plain(q, k, v, *, causal: bool = True, window: int = 0,
                         tiles: tuple = (128, 128), scale: float = None):
    """(out in q's dtype, the log-sum-exp (B, KV, G, Sq) float32): the bf16
    forward in the ``wgmma`` kernel's order and arithmetic (plain PyTorch; each
    tile's products by ``einsum``).  Each consumer warpgroup's rows visit their
    key tiles (``visited_tiles("forward_bf16")``) in ascending order, keeping
    m, l and the accumulator in float32 in the log2 domain: x = s·(scale·log2 e)
    (the factor rounded to float32, as the kernel's), NEG where the causal or
    window mask hides a key (keys past Sk, -inf in the kernel, add 0 and are
    left out), p = 2^(x − m), l summing p in float32, P rounded to bf16 before
    P·V; out = acc / max(l, 1e-30), lse = m·ln 2 + log(max(l, 1e-30)).  (On a
    tile no mask cuts the kernel forms x − m in one FMA, and it sums l over
    partial chains: rounding differences of a float32 ulp.)"""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    hdv = v.shape[-1]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    f32 = torch.float32
    dev = q.device
    scale_log2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    qf = q.float().reshape(b, sq, kv, g, hd)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, sq, kv, g, hdv), dtype=f32, device=dev)
    lse = torch.zeros((b, kv, g, sq), dtype=f32, device=dev)
    visits = {}
    for rows, keys, _ in visited_tiles("forward_bf16", sq, sk, causal, window, tiles=tiles):
        visits.setdefault(rows, []).append(keys)
    for r0 in range(0, sq, BF16_FWD_WG_ROWS):
        r1 = min(r0 + BF16_FWD_WG_ROWS, sq)
        qt, qpos = qf[:, r0:r1], torch.arange(r0, r1, device=dev)
        m = torch.full((b, kv, g, r1 - r0), NEG, dtype=f32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kv, g, r1 - r0, hdv), dtype=f32, device=dev)
        for k0, k1 in visits.get((r0, r1), []):
            kpos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            x = torch.einsum("bqkgd,bskd->bkgqs", qt, kf[:, k0:k1]) * scale_log2
            x = torch.where(mask, x, NEG)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(torch.bfloat16).float(), vf[:, k0:k1])
            m = m_new
        out[:, r0:r1] = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
        lse[..., r0:r1] = m * LN2 + torch.log(torch.clamp(l, min=1e-30))
    return out.reshape(b, sq, h, hdv).to(q.dtype), lse


def flash_bwd_key_major_plain(q, k, v, out, dout, lse, *, causal: bool = True, window: int = 0,
                              tiles: tuple = (64, 64), scale: float = None):
    """(dq, dk, dv) in q's dtype, summed in the float32 backward kernel's
    order (plain PyTorch; each tile's products by ``einsum``): the key tiles
    of ``tiles[0]`` keys in ascending order, each over the query tiles of
    ``tiles[1]`` rows of ``query_span``, from the last down, and the G query
    heads inside each (``visited_tiles("backward")``); a tile pair adds its dQ-partial ·
    scale into dq (so dq sums its key tiles in ascending order), dK and dV
    accumulate over the item's steps, and dK is scaled once at the end.
    P = exp(s·scale − lse), 0 where the mask hides the pair; lse is (B, KV, G,
    Sq), ``models/flash.py``'s."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dev = q.device
    qf, dof, of = (x.float().reshape(b, sq, kv, g, x.shape[-1]) for x in (q, dout, out))
    kf, vf = k.float(), v.float()
    delta = (dof * of).sum(-1)                                      # (B, Sq, KV, G)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=dev)
    bn, bm = tiles
    for n in range((sk + bn - 1) // bn):
        k0, k1 = n * bn, min(n * bn + bn, sk)
        kt, vt = kf[:, k0:k1], vf[:, k0:k1]                          # (B, n, KV, hd)
        kpos = torch.arange(k0, k1, device=dev)
        dk_acc = torch.zeros(kt.shape, dtype=torch.float32, device=dev)
        dv_acc = torch.zeros(vt.shape, dtype=torch.float32, device=dev)
        t_lo, t_hi = query_span(k0, k1, bm, sq, causal, window)
        for j in range((t_hi - t_lo) * g):
            t, gi = t_hi - 1 - j // g, j % g
            q0, q1 = t * bm, min(t * bm + bm, sq)
            qt, dot = qf[:, q0:q1, :, gi], dof[:, q0:q1, :, gi]     # (B, m, KV, hd)
            qpos = torch.arange(q0, q1, device=dev)
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.einsum("bqkd,bskd->bkqs", qt, kt)
            p = torch.where(mask, torch.exp(s * scale - lse[:, :, gi, q0:q1, None]), 0.0)
            dp = torch.einsum("bqkd,bskd->bkqs", dot, vt)
            ds = p * (dp - delta[:, q0:q1, :, gi].permute(0, 2, 1)[..., None])
            dv_acc += torch.einsum("bkqs,bqkd->bskd", p, dot)
            dk_acc += torch.einsum("bkqs,bqkd->bskd", ds, qt)
            dq[:, q0:q1, :, gi] += torch.einsum("bkqs,bskd->bqkd", ds, kt) * scale
        dk[:, k0:k1] = dk_acc * scale
        dv[:, k0:k1] = dv_acc
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
