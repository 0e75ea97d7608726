"""Decoder-only transformer LM, dense and MoE (port of ``repro.models.transformer``).

Parameters: ``{"embed", "final_norm", "head" (untied only), "lead_blocks"
(MoE configs with ``first_dense_layers``), "blocks"}`` where each block
group is a list of per-layer dicts (the JAX package stacks them for
``lax.scan``; here ``_backbone`` loops over the lists).  Serving uses a
position-indexed cache ``{"main", "lead"}`` of (L, B, S_max, ...) buffers,
written in place by ``lm_decode_step``: full k/v ``{"k", "v"}`` for GQA,
the compressed latent ``{"c", "kr"}`` for MLA, whose decode scores and
reads out in latent space (matrix-absorbed).  A config with a ``window``
keeps a ring of ``min(window, S_max)`` rows instead (``cm.cached_attention``):
past the window it equals the windowed forward, where the JAX package's
clamped write does not (ROADMAP.md C).

The forward and decode run the MoE at full capacity (every token kept), so
decode logits match the parallel forward.  ``lm_loss`` (A13d) is not ported
yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, h = cfg.d_model, cfg.n_heads
    hd, rhd, vhd = cfg.hd, cfg.rope_head_dim, cfg.vhd
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=gen.device)
    p = {}
    if cfg.q_lora:
        p["wdq"] = cm.dense_init(gen, d, cfg.q_lora, dtype)
        p["q_norm"] = zeros(cfg.q_lora)
        p["wuq"] = cm.dense_init(gen, cfg.q_lora, h * (hd + rhd), dtype)
    else:
        p["wq"] = cm.dense_init(gen, d, h * (hd + rhd), dtype)
    p["wdkv"] = cm.dense_init(gen, d, cfg.kv_lora + rhd, dtype)
    p["kv_norm"] = zeros(cfg.kv_lora)
    p["wuk"] = cm.dense_init(gen, cfg.kv_lora, h * hd, dtype)
    p["wuv"] = cm.dense_init(gen, cfg.kv_lora, h * vhd, dtype)
    p["wo"] = cm.dense_init(gen, h * vhd, d, dtype)
    return p


def _mla_q(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, hd, rhd = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    if cfg.q_lora:
        q = cm.rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, h, hd + rhd)
    return q[..., :hd], cm.rope(q[..., hd:], positions, cfg.rope_theta)


def _mla_latent(p, x, cfg: ModelConfig, positions):
    ckv = x @ p["wdkv"]                                       # (B, S, kv_lora + rhd)
    c = cm.rmsnorm(ckv[..., :cfg.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = cm.rope(ckv[..., cfg.kv_lora:][:, :, None, :], positions,
                     cfg.rope_theta)                          # (B, S, 1, rhd)
    return c, k_rope


def mla_apply(p, x, cfg: ModelConfig, positions=None):
    """Prefill: per-head k and v materialised from the latent, then flash
    attention at q·k head dim hd + rhd against v's vhd (the kernel pads
    both to its table and takes the scale 1/sqrt(hd + rhd))."""
    b, s, _ = x.shape
    h, hd, rhd, vhd = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.vhd
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = (c @ p["wuk"]).reshape(b, s, h, hd)
    v = (c @ p["wuv"]).reshape(b, s, h, vhd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rhd)], dim=-1)
    out = cm.flash_attention(q, k, v, causal=True)
    return out.reshape(b, s, h * vhd) @ p["wo"]


def mla_decode(p, x, cache_c, cache_kr, pos, cfg: ModelConfig):
    """Matrix-absorbed decode: score and read out in latent space.

    cache_c: (B, S_max, kv_lora); cache_kr: (B, S_max, rhd), written in
    place at row b's position ``pos[b]``; pos: (B,) int64 (the JAX package
    takes one scalar position and its engine vmaps over the slots).  Row b
    attends to ``cache[b, :pos[b] + 1]``.  Returns (out, cache_c, cache_kr).
    """
    b = x.shape[0]
    h, hd, rhd, vhd, kl = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.vhd, cfg.kv_lora
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])          # (B, 1, H, ·)
    c, k_rope = _mla_latent(p, x, cfg, pos[:, None])          # (B, 1, kl), (B, 1, 1, rhd)
    rows = torch.arange(b, device=x.device)
    cache_c[rows, pos] = c[:, 0].to(cache_c.dtype)
    cache_kr[rows, pos] = k_rope[:, 0, 0].to(cache_kr.dtype)
    # absorb W_uk into q: q_lat (B, H, kl)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], p["wuk"].reshape(kl, h, hd))
    s_nope = torch.einsum("bhc,bsc->bhs", q_lat.float(), cache_c.float())
    s_rope = torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), cache_kr.float())
    scores = (s_nope + s_rope) / math.sqrt(hd + rhd)
    live = torch.arange(cache_c.shape[1], device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(live[:, None, :], scores, cm.NEG)
    pr = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsc->bhc", pr, cache_c.float())            # (B, H, kl)
    out = torch.einsum("bhc,chd->bhd", o_lat, p["wuv"].reshape(kl, h, vhd).float())
    out = out.reshape(b, 1, h * vhd).to(x.dtype) @ p["wo"]
    return out, cache_c, cache_kr


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, use_moe: bool = False) -> Params:
    dtype = cfg.torch_dtype
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    p = {"ln1": zeros(), "ln2": zeros(),
         "attn": mla_init(gen, cfg, dtype) if cfg.use_mla else cm.attn_init(gen, cfg, dtype)}
    if use_moe:
        p["moe"] = cm.moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = cm.ffn_init(gen, cfg, dtype=dtype)
    return p


def block_apply(p, x, cfg: ModelConfig, use_moe: bool = False, positions=None):
    """Returns (x, the MoE layer's load-balance aux term or 0)."""
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        x = x + mla_apply(p["attn"], h, cfg, positions)
    else:
        x = x + cm.attn_apply(p["attn"], h, cfg, window=cfg.window, positions=positions)
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_moe:
        b, s, d = h.shape
        # capacity = T: no token is dropped, and decode matches the forward
        y, moe_aux = cm.moe_apply(p["moe"], h.reshape(b * s, d), cfg, capacity=b * s)
        return x + y.reshape(b, s, d), moe_aux["moe_aux"].float()
    return x + cm.ffn_apply(p["ffn"], h, cfg), aux


def block_decode(p, x, cache, pos, cfg: ModelConfig, use_moe: bool = False):
    """One-token decode through a block.  ``cache``: this layer's buffers
    (``{"k", "v"}`` (B, S_max, KV, hd), a ring of the window's rows if the
    config has one, or MLA's ``{"c", "kr"}``), written in place at row b's
    position ``pos[b]``; ``pos``: (B,) int64.  Returns (x, cache)."""
    b = x.shape[0]
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out, _, _ = mla_decode(p["attn"], h, cache["c"], cache["kr"], pos, cfg)
    else:
        q, k, v = cm.attn_qkv(p["attn"], h, cfg, pos[:, None])
        out = cm.cached_attention(q, k, v, cache["k"], cache["v"], pos, ring=bool(cfg.window))
        attn_out = out.reshape(b, 1, -1) @ p["attn"]["wo"]
    x = x + attn_out
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        s = h.shape[1]
        # capacity = the step's tokens: an expert takes at most one lane a
        # token, so none is dropped (the JAX engine's vmapped step runs each
        # slot at capacity 1: the same function)
        y, _ = cm.moe_apply(p["moe"], h.reshape(b * s, -1), cfg, capacity=b * s)
        return x + y.reshape(b, s, -1), cache
    return x + cm.ffn_apply(p["ffn"], h, cfg), cache


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                     device) -> Dict[str, torch.Tensor]:
    dtype = cfg.torch_dtype
    if cfg.use_mla:
        return {"c": torch.zeros(n_layers, batch, max_len, cfg.kv_lora, dtype=dtype,
                                 device=device),
                "kr": torch.zeros(n_layers, batch, max_len, cfg.rope_head_dim, dtype=dtype,
                                  device=device)}
    rows = min(cfg.window, max_len) if cfg.window else max_len
    shape = (n_layers, batch, rows, cfg.n_kv_heads)
    return {"k": torch.zeros(*shape, cfg.hd, dtype=dtype, device=device),
            "v": torch.zeros(*shape, cfg.vhd, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# LM: init / prefill / decode
# ---------------------------------------------------------------------------


def _split_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(#leading dense-FFN layers, #main layers)."""
    lead = cfg.first_dense_layers if cfg.n_experts else 0
    return lead, cfg.n_layers - lead


def _groups(p, cfg: ModelConfig):
    """(group name, its layers, use_moe) in the order the layers run."""
    lead, _ = _split_groups(cfg)
    return ([("lead", p["lead_blocks"], False)] if lead else []) + \
        [("main", p["blocks"], bool(cfg.n_experts))]


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dtype = cfg.torch_dtype
    lead, main = _split_groups(cfg)
    p: Params = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    if lead:
        p["lead_blocks"] = [block_init(gen, cfg, use_moe=False) for _ in range(lead)]
    p["blocks"] = [block_init(gen, cfg, use_moe=bool(cfg.n_experts)) for _ in range(main)]
    return p


def _embed(p, tokens, cfg: ModelConfig):
    x = p["embed"][tokens]
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _logits(p, x, cfg: ModelConfig):
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    logits = x @ head
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _backbone(p, x, cfg: ModelConfig, positions=None):
    """(final-normed hiddens, the summed MoE aux term)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, layers, use_moe in _groups(p, cfg):
        for layer in layers:
            x, aux = block_apply(layer, x, cfg, use_moe, positions)
            aux_total = aux_total + aux
    return cm.rmsnorm(x, p["final_norm"], cfg.norm_eps), aux_total


def lm_loss(p, batch, cfg: ModelConfig):
    raise NotImplementedError("lm_loss (training, flash.py's backward) is not ported yet "
                              "(ROADMAP.md A13d)")


def lm_forward(p, tokens, cfg: ModelConfig, *, last_only: bool = False):
    """Sequence logits (B, S, padded_vocab), the MoE at full capacity.
    ``last_only`` returns just the final position — the production prefill
    contract (no (B, S, V) buffer)."""
    x, _ = _backbone(p, _embed(p, tokens, cfg), cfg)
    if last_only:
        x = x[:, -1:, :]
    return _logits(p, x, cfg)


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    lead, main = _split_groups(cfg)
    caches = {"main": init_block_cache(cfg, batch, max_len, main, device)}
    if lead:
        caches["lead"] = init_block_cache(cfg, batch, max_len, lead, device)
    return caches


def lm_decode_step(p, cache, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) int64; pos: the index the new token
    occupies (attends to cache[:pos + 1]) — an int, or a (B,) tensor of one
    index per row.  Updates ``cache`` in place; returns (logits, cache)."""
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device).reshape(-1).expand(b)
    x = _embed(p, tokens, cfg)
    for group, layers, use_moe in _groups(p, cfg):
        bufs = cache[group]
        for i, layer in enumerate(layers):
            x, _ = block_decode(layer, x, {name: buf[i] for name, buf in bufs.items()}, pos,
                                cfg, use_moe)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return _logits(p, x, cfg), cache
