"""Building blocks of the decoder LM (port of ``repro.models.common``).

Parameters are plain dicts of tensors keyed as the JAX package's pytrees,
weights in ``(d_in, d_out)`` orientation, so ``x @ w`` reads as in JAX.
Init functions draw from an explicit ``torch.Generator`` on the target
device; ``*_apply`` functions are plain tensor functions.  Attention in the
token-parallel forward goes through the flash-attention kernel op, which
launches the hand-written kernel on CUDA tensors and runs the plain
blockwise version (``models/flash.py``) on CPU tensors.

Here: GQA attention, the dense FFNs, the sort-based top-k MoE (with
training's capacity factor, local groups and scatter combine) and the
chunked cross-entropy of training (``ce_loss``).  Under autograd the
attention's gradient comes from the kernel op's hand-written backward.  The
JAX package's ``blocked_attention`` (its serving prefill, which the port
runs through flash) and its sharding constraint (the identity on one
device) have no counterpart.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

NEG = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _trunc_normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _trunc_normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    # 1/sqrt(d) scale keeps tied-head logits O(1) at init
    return _trunc_normal(gen, (vocab, d), 1.0 / math.sqrt(d), dtype)


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Llama-style rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq       # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]              # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def activation(name: str):
    if name in ("swiglu", "geglu"):
        raise ValueError("gated activations are applied inside ffn_apply")
    return {"relu2": lambda u: F.relu(u).square(),
            "gelu": lambda u: F.gelu(u, approximate="tanh"), "silu": F.silu}[name]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-position attention over a padded KV cache.

    q: (B, 1, H, hd); caches: (B, S_max, KV, hd); kv_len: live length
    (including the current token), an int or a (B,) tensor of one length per
    row — the serving engine's slots sit at different positions.
    """
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kv, g, hd).float(),
                     k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)   # (B or 1, 1)
    s = torch.where((pos[None, :] < kv_len)[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def cached_attention(q, k, v, k_cache, v_cache, pos, *, ring: bool = False):
    """One decode step's attention through a KV cache, written in place.

    q: (B, 1, H, hd); k, v: (B, 1, KV, ·), this step's; caches (B, R, KV, ·);
    pos: (B,) int64, the index each row's token occupies.  A plain cache is
    written at ``pos[b]`` and read over ``pos[b] + 1`` rows.  A ring (R =
    ``min(window, max_len)`` rows) is written at ``pos[b] % R`` and read over
    ``min(pos[b] + 1, R)`` rows, so it holds each row's last R positions:
    the window the forward's mask leaves (the JAX ``rglru`` rule, per row).
    """
    rows = torch.arange(q.shape[0], device=q.device)
    r = k_cache.shape[1]
    slot, kv_len = (pos % r, torch.clamp(pos + 1, max=r)) if ring else (pos, pos + 1)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    return decode_attention(q, k_cache, v_cache, kv_len)


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kvh * hd, dtype),
        "wv": dense_init(gen, d, kvh * cfg.vhd, dtype),
        "wo": dense_init(gen, h * cfg.vhd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=gen.device)
    return p


def attn_qkv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, cfg.vhd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attn_apply(p, x, cfg: ModelConfig, *, window: int = 0, positions=None):
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = attn_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None, dtype=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dtype = dtype or cfg.torch_dtype
    if cfg.act in ("swiglu", "geglu"):
        return {"w1": dense_init(gen, d, f, dtype), "w3": dense_init(gen, d, f, dtype),
                "w2": dense_init(gen, f, d, dtype)}
    return {"w1": dense_init(gen, d, f, dtype), "w2": dense_init(gen, f, d, dtype)}


def ffn_apply(p, x, cfg: ModelConfig):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
    if cfg.act == "geglu":
        return (F.gelu(x @ p["w1"], approximate="tanh") * (x @ p["w3"])) @ p["w2"]
    return activation(cfg.act)(x @ p["w1"]) @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture of Experts — sort-based dispatch
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, e, torch.float32, scale=0.02),
        "w1": _stack_init(gen, e, d, f, dtype),
        "w2": _stack_init(gen, e, f, d, dtype),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = _stack_init(gen, e, d, f, dtype)
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts, dtype=dtype)
    return p


def _stack_init(gen: torch.Generator, e: int, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """(e, d_in, d_out) expert weights, drawn an expert at a time so the
    float32 temporary is one expert's (kimi-k2's stack is 11 GB in bf16)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e):
        out[i] = _trunc_normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)
    return out


def moe_apply(p, x, cfg: ModelConfig, capacity: Optional[int] = None):
    """Top-k MoE with sort-based capacity dispatch.

    x: (T, d) flattened tokens; ``capacity``: slots per expert, or None for
    training's ``int(T·k/E·capacity_factor)`` (at least 1), as the JAX
    package computes it.  Returns (T, d) and the aux dict ``{"moe_aux",
    "dropped"}``.  The forward and decode pass ``capacity = T``: an expert
    takes at most one lane a token, so nothing is dropped.

    ``cfg.moe_local_groups > 1`` (and dividing T): the tokens split into that
    many groups, each routing its own tokens at the capacity of its T / g
    (or ``capacity``); the aux terms are the groups' mean (JAX's vmap, then
    ``tree_map(mean)``).
    """
    g = cfg.moe_local_groups
    t_all = x.shape[0]
    if g > 1 and t_all % g == 0:
        tl = t_all // g
        cap = capacity or max(1, int(tl * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
        outs = [_moe_dispatch(p, x[i * tl:(i + 1) * tl], cfg, cap) for i in range(g)]
        aux = {name: torch.stack([a[name] for _, a in outs]).mean() for name in outs[0][1]}
        return torch.cat([y for y, _ in outs]), aux
    cap = capacity or max(1, int(t_all * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return _moe_dispatch(p, x, cfg, cap)


def _moe_dispatch(p, x, cfg: ModelConfig, cap: int):
    """One group's dispatch, experts and combine, the JAX package's order
    step for step: softmax, a sorted top-k, the gates normalised; a stable
    sort of the flat expert ids; each kept lane at ``expert · cap + its
    rank`` in the expert's queue, a lane past the capacity at the overflow
    slot ``E · cap`` (dropped).  The combine adds each token's k terms in
    ``x.dtype`` in the sorted order, by increasing expert id, as XLA's
    ``.at[token].add`` does on the CPU: here a gather and k adds, so the
    card adds in that order too (no atomics).  ``cfg.moe_combine`` is
    accepted as ``"gather"`` or ``"scatter"`` and both run this one path:
    JAX's expert-side ``"scatter"`` form adds the same terms,
    ``out_e[slot] · gate``, in the same order a token, so its sums are
    these."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    probs, gates, idx = moe_route(p, x, cfg)

    flat_e = idx.reshape(-1)                                        # (T·k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    token_of = sort_idx // k
    counts = torch.bincount(sorted_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)    # overflow slot

    # each kept lane has a slot of its own; the overflow slot is cut off
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x[token_of]
    buf = buf[:-1].reshape(e, cap, d)

    h = torch.bmm(buf, p["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(buf, p["w3"])
    elif cfg.act == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.bmm(buf, p["w3"])
    else:
        h = activation(cfg.act)(h)
    out_e = torch.bmm(h, p["w2"]).reshape(e * cap, d)

    gates_sorted = gates.reshape(-1)[sort_idx]
    gath = torch.where(keep[:, None], out_e[dest.clamp_max(e * cap - 1)], 0)
    contrib = gath * gates_sorted[:, None].to(x.dtype)
    y = combine_in_order(contrib, sort_idx, t, k)

    if cfg.n_shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg)

    # load-balance aux loss (Switch): E · Σ_e f_e · p_e
    frac = torch.bincount(flat_e, minlength=e) / (t * k)
    aux = e * (frac * probs.mean(0)).sum()
    return y, {"moe_aux": aux, "dropped": 1.0 - keep.float().mean()}


def moe_route(p, x, cfg: ModelConfig):
    """(router probs (T, E) float32, normalised gates (T, k), expert ids
    (T, k) by falling prob): softmax, then a sorted top-k."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def combine_in_order(contrib, sort_idx, t: int, k: int):
    """y[token] = Σ of the token's rows of ``contrib`` (T·k rows in the
    sorted order ``sort_idx`` gave), added one at a time in that order into
    a zero row of ``contrib.dtype``: each token's lanes are found through
    the inverse of the sort, and a token's lanes are sorted by expert id."""
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(t * k, device=sort_idx.device)
    lanes = inv.reshape(t, k).sort(dim=1).values                    # (T, k), in sorted order
    y = contrib.new_zeros(t, contrib.shape[1])
    for j in range(k):
        y = y + contrib[lanes[:, j]]
    return y


# ---------------------------------------------------------------------------
# chunked cross-entropy (memory-bounded loss head)
# ---------------------------------------------------------------------------


def _chunk_nll(xc, head, tc, mc, vmask_neg, tied: bool, logit_softcap: float):
    logits = (torch.einsum("bsd,vd->bsv", xc, head) if tied else xc @ head).float()
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    logits = logits + vmask_neg
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    return ((lse - tgt) * mc).sum()


def ce_loss(x, head, targets, loss_mask, vocab: int, padded_vocab: int, *,
            tied: bool = False, logit_softcap: float = 0.0, chunk_seq: int = 256):
    """Causal-LM cross-entropy with the (B, S, padded_vocab) logits never
    whole: sequence chunks of ``chunk_seq`` each compute their float32
    logits, log-sum-exp and target logit, and are recomputed in the backward
    (``torch.utils.checkpoint``); the chunks' sums are added in order, as
    the JAX package's checkpointed scan adds them.  A sequence that is not
    a multiple of the chunk is zero-padded (masked out); logits of the
    padded vocabulary get -1e30.

    x: (B, S, D) final hiddens; head: (D, Vp), or (Vp, D) when ``tied``;
    targets, loss_mask: (B, S) (the mask may broadcast).  Returns the mean
    NLL over the masked positions (float32).
    """
    b, s, _ = x.shape
    ck = min(chunk_seq, s)
    n_chunks = -(-s // ck)
    pad = n_chunks * ck - s
    mf = torch.broadcast_to(loss_mask, (b, s)).float()
    targets = targets.long()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mf = F.pad(mf, (0, pad))
    vmask_neg = torch.where(torch.arange(padded_vocab, device=x.device) < vocab, 0.0,
                            -1e30).float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        total = total + checkpoint(_chunk_nll, x[:, sl], head, targets[:, sl], mf[:, sl],
                                   vmask_neg, tied, logit_softcap, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / torch.clamp(mf.sum(), min=1.0)
