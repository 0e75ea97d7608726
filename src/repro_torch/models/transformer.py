"""Decoder-only transformer LM, the dense family (port of ``repro.models.transformer``).

Parameters: ``{"embed", "final_norm", "head" (untied only), "blocks"}`` where
``blocks`` is a list of per-layer dicts (the JAX package stacks them for
``lax.scan``; here ``_backbone`` loops over the list).  Serving uses a
position-indexed KV cache ``{"main": {"k", "v"}}`` of shape
(L, B, S_max, KV, hd), written in place by ``lm_decode_step``.

MLA and MoE blocks, the windowed ring cache and ``lm_loss`` are not ported
yet (ROADMAP A13) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP.md A13)")
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP.md A13)")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    _check_dense(cfg)
    dtype = cfg.torch_dtype
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return {"ln1": zeros(), "ln2": zeros(), "attn": cm.attn_init(gen, cfg, dtype),
            "ffn": cm.ffn_init(gen, cfg, dtype=dtype)}


def block_apply(p, x, cfg: ModelConfig, positions=None):
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + cm.attn_apply(p["attn"], h, cfg, window=cfg.window, positions=positions)
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + cm.ffn_apply(p["ffn"], h, cfg)


def block_decode(p, x, cache, pos, cfg: ModelConfig):
    """One-token decode through a block.  ``cache``: this layer's ``{"k", "v"}``
    (B, S_max, KV, hd), written in place at row b's position ``pos[b]``;
    ``pos``: (B,) int64.  Returns (x, cache)."""
    b = x.shape[0]
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv(p["attn"], h, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    out = cm.decode_attention(q, cache["k"], cache["v"], pos + 1, window=cfg.window)
    x = x + out.reshape(b, 1, -1) @ p["attn"]["wo"]
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + cm.ffn_apply(p["ffn"], h, cfg), cache


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                     device) -> Dict[str, torch.Tensor]:
    _check_dense(cfg)
    if cfg.window:
        raise NotImplementedError("the windowed ring cache is not ported yet (ROADMAP.md A13)")
    shape = (n_layers, batch, max_len, cfg.n_kv_heads)
    return {"k": torch.zeros(*shape, cfg.hd, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(*shape, cfg.vhd, dtype=cfg.torch_dtype, device=device)}


# ---------------------------------------------------------------------------
# LM: init / prefill / decode
# ---------------------------------------------------------------------------


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dtype = cfg.torch_dtype
    p: Params = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    p["blocks"] = [block_init(gen, cfg) for _ in range(cfg.n_layers)]
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
    for layer in p["blocks"]:
        x = block_apply(layer, x, cfg, positions)
    return cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)


def lm_loss(p, batch, cfg: ModelConfig):
    raise NotImplementedError("lm_loss (training, flash.py's backward) is not ported yet "
                              "(ROADMAP.md A13)")


def lm_forward(p, tokens, cfg: ModelConfig, *, last_only: bool = False):
    """Sequence logits (B, S, padded_vocab).  ``last_only`` returns just the
    final position — the production prefill contract (no (B, S, V) buffer)."""
    _check_dense(cfg)
    x = _backbone(p, _embed(p, tokens, cfg), cfg)
    if last_only:
        x = x[:, -1:, :]
    return _logits(p, x, cfg)


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    return {"main": init_block_cache(cfg, batch, max_len, cfg.n_layers, device)}


def lm_decode_step(p, cache, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) int64; pos: the index the new token
    occupies (attends to cache[:pos + 1]) — an int, or a (B,) tensor of one
    index per row.  Updates ``cache`` in place; returns (logits, cache)."""
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device).reshape(-1).expand(b)
    x = _embed(p, tokens, cfg)
    main = cache["main"]
    for i, layer in enumerate(p["blocks"]):
        x, _ = block_decode(layer, x, {"k": main["k"][i], "v": main["v"][i]}, pos, cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return _logits(p, x, cfg), cache
