"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention (port of ``repro.models.rglru``).

Layer pattern "rra" (two recurrent blocks, one local-MQA attention block)
tiled over ``n_layers``.  The RG-LRU recurrence

    a_t = exp(-c · softplus(Λ) · r_t),   r_t = σ(W_r x_t),  i_t = σ(W_i x_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

is diagonal, so it runs through mamba's chunked scan (state (B, d_rnn)).
Local attention goes through ``cm.attn_apply`` with the config's window,
so through the flash-attention kernel on the card.

Parameters: ``{"embed", "final_norm", "head" (untied only), "blocks"}``,
``blocks`` a list in pattern order of ``{"kind_r": ..., "mlp": ...}`` or
``{"kind_a": {"ln", "attn"}, "mlp": ...}``, as the JAX pytree.  The cache
groups the layers by kind, axis 1 the slot: ``{"rec": {"h": (n_r, B,
d_rnn) float32, "conv": (n_r, B, K − 1, d_rnn)}, "attn": {"k", "v": (n_a,
B, min(window, max_len), KV, hd)}}``; the attention rows are a ring,
written at ``pos[b] % R`` and read over ``min(pos[b] + 1, R)`` rows (JAX's
rule, with one position a row).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import _causal_conv, chunk_len, scan_chunk
from repro_torch.models.transformer import _embed, _logits, loss_targets, remat_call

LRU_C = 8.0

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------


def rec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_dtype
    d, dr, k = cfg.d_model, cfg.d_rnn, cfg.conv_kernel
    dev = gen.device
    # Λ so that a ∈ [0.9, 0.999] at r = 1 (Griffin §2.4): softplus⁻¹(-log a / c)
    u = torch.empty(dr, dtype=torch.float32, device=dev).uniform_(0.9, 0.999, generator=gen)
    return {
        "ln": torch.zeros(d, dtype=dtype, device=dev),
        "in_x": cm.dense_init(gen, d, dr, dtype),
        "in_gate": cm.dense_init(gen, d, dr, dtype),
        "conv_w": cm._trunc_normal(gen, (k, dr), 1.0 / math.sqrt(k), dtype),
        "conv_b": torch.zeros(dr, dtype=dtype, device=dev),
        "w_r": cm.dense_init(gen, dr, dr, dtype),
        "w_i": cm.dense_init(gen, dr, dr, dtype),
        "lam": torch.log(torch.exp(-torch.log(u) / LRU_C) - 1.0),
        "out": cm.dense_init(gen, dr, d, dtype),
    }


def _lru_scan(a, bx, h0):
    """h_t = a_t·h_{t−1} + bx_t by chunks.  a, bx: (B, S, dr) float32; h0:
    (B, dr).  Returns every h_t (B, S, dr) and the final state."""
    ck = chunk_len(a.shape[1])
    h, hs = h0, []
    for lo in range(0, a.shape[1], ck):
        h_t = scan_chunk(a[:, lo:lo + ck], bx[:, lo:lo + ck], h)
        hs.append(h_t)
        h = h_t[:, -1]
    return torch.cat(hs, dim=1), h


def _lru_gates(p, xc):
    """(a, the gated input) in float32 from the conv output xc (B, S, dr)."""
    xf = xc.float()
    r = torch.sigmoid(xf @ p["w_r"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    a = torch.exp(-LRU_C * F.softplus(p["lam"])[None, None] * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xf


def _rec_in(p, x, cfg: ModelConfig, conv_state):
    """Norm, gate branch and conv branch: (gate, xc, new conv state)."""
    x = cm.rmsnorm(x, p["ln"], cfg.norm_eps)
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    xc, conv_state = _causal_conv(x @ p["in_x"], p["conv_w"], p["conv_b"], conv_state)
    return gate, xc, conv_state


def rec_block_apply(p, x, cfg: ModelConfig, h0=None, conv_state=None):
    """Full-sequence RG-LRU block.  Returns (x_out, (h_final, conv_state))."""
    gate, xc, conv_state = _rec_in(p, x, cfg, conv_state)
    a, gated = _lru_gates(p, xc)
    if h0 is None:
        h0 = torch.zeros(x.shape[0], cfg.d_rnn, dtype=torch.float32, device=x.device)
    h, h_final = _lru_scan(a, gated, h0)
    return x + (h.to(x.dtype) * gate) @ p["out"], (h_final, conv_state)


def rec_block_decode(p, x, cache, cfg: ModelConfig):
    """One-token step.  cache = {"h": (B, dr) float32, "conv": (B, K − 1,
    dr)}, this layer's rows, written in place.  Returns (x, cache)."""
    gate, xc, conv_state = _rec_in(p, x, cfg, cache["conv"])
    a, gated = _lru_gates(p, xc)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return x + (h[:, None].to(x.dtype) * gate) @ p["out"], cache


# ---------------------------------------------------------------------------
# Hybrid LM: pattern-tiled blocks
# ---------------------------------------------------------------------------


def _mlp_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln": torch.zeros(cfg.d_model, dtype=cfg.torch_dtype, device=gen.device),
            "ffn": cm.ffn_init(gen, cfg, dtype=cfg.torch_dtype)}


def _mlp_apply(p, x, cfg: ModelConfig):
    return x + cm.ffn_apply(p["ffn"], cm.rmsnorm(x, p["ln"], cfg.norm_eps), cfg)


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dtype = cfg.torch_dtype
    blocks = []
    for kind in cfg.pattern():
        if kind == "r":
            blocks.append({"kind_r": rec_block_init(gen, cfg), "mlp": _mlp_init(gen, cfg)})
        else:
            attn = {"ln": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
                    "attn": cm.attn_init(gen, cfg, dtype)}
            blocks.append({"kind_a": attn, "mlp": _mlp_init(gen, cfg)})
    p: Params = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    return p


def _apply_block(blk, x, cfg: ModelConfig):
    """One pattern block: the RG-LRU or local-attention mixer, then the MLP."""
    if "kind_r" in blk:
        x, _ = rec_block_apply(blk["kind_r"], x, cfg)
    else:
        a = blk["kind_a"]
        x = x + cm.attn_apply(a["attn"], cm.rmsnorm(x, a["ln"], cfg.norm_eps), cfg,
                              window=cfg.window)
    return _mlp_apply(blk["mlp"], x, cfg)


def _backbone(p, x, cfg: ModelConfig, *, remat: bool = False):
    for blk in p["blocks"]:
        x = remat_call(lambda b, h: _apply_block(b, h, cfg), blk, x, remat=remat)
    return cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)


def lm_loss(p, batch, cfg: ModelConfig, *, remat: bool = True):
    """Causal LM loss (float32), each block recomputed in the backward when
    ``remat``; batch = {"tokens": (B, S) int}."""
    tokens = batch["tokens"]
    x = _backbone(p, _embed(p, tokens, cfg), cfg, remat=remat)
    targets, mask = loss_targets(tokens)
    head = p["embed"] if cfg.tie_embeddings else p["head"]
    return cm.ce_loss(x, head, targets, mask, cfg.vocab, cfg.padded_vocab,
                      tied=cfg.tie_embeddings)


def lm_forward(p, tokens, cfg: ModelConfig, *, last_only: bool = False):
    """Sequence logits (B, S, padded_vocab), or the last position's."""
    x = _backbone(p, _embed(p, tokens, cfg), cfg)
    if last_only:
        x = x[:, -1:, :]
    return _logits(p, x, cfg)


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    """The recurrent layers' state and conv window, and the attention
    layers' ring of ``min(window, max_len)`` rows; a kind with no layer has
    no group."""
    kinds = cfg.pattern()
    n_r, n_a = kinds.count("r"), kinds.count("a")
    win = min(cfg.window or max_len, max_len)
    cache: Dict[str, Any] = {}
    if n_r:
        cache["rec"] = {
            "h": torch.zeros(n_r, batch, cfg.d_rnn, dtype=torch.float32, device=device),
            "conv": torch.zeros(n_r, batch, cfg.conv_kernel - 1, cfg.d_rnn,
                                dtype=cfg.torch_dtype, device=device)}
    if n_a:
        shape = (n_a, batch, win, cfg.n_kv_heads)
        cache["attn"] = {
            "k": torch.zeros(*shape, cfg.hd, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(*shape, cfg.vhd, dtype=cfg.torch_dtype, device=device)}
    return cache


def lm_decode_step(p, cache, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1); pos: the index the new token
    occupies, an int or a (B,) tensor.  Updates ``cache`` in place; returns
    (logits, cache)."""
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device).reshape(-1).expand(b)
    x = _embed(p, tokens, cfg)
    seen = {"rec": 0, "attn": 0}
    for blk in p["blocks"]:
        group = "rec" if "kind_r" in blk else "attn"
        layer = {name: buf[seen[group]] for name, buf in cache[group].items()}
        seen[group] += 1
        if group == "rec":
            x, _ = rec_block_decode(blk["kind_r"], x, layer, cfg)
        else:
            a = blk["kind_a"]
            q, k, v = cm.attn_qkv(a["attn"], cm.rmsnorm(x, a["ln"], cfg.norm_eps), cfg,
                                  pos[:, None])
            out = cm.cached_attention(q, k, v, layer["k"], layer["v"], pos, ring=True)
            x = x + out.reshape(b, 1, -1) @ a["attn"]["wo"]
        x = _mlp_apply(blk["mlp"], x, cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return _logits(p, x, cfg), cache
