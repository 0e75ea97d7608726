"""Encoder-decoder transformer, the seamless-m4t-medium backbone (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  The encoder is
bidirectional (flash with ``causal=False``); each decoder block runs causal
self-attention (``cm.attn_apply``), then cross-attention over the encoder
memory (flash, ``causal=False``, q and k of different lengths; no RoPE on
either), then the FFN.

Serving: ``prefill_cross`` runs the encoder once and fills each layer's
cross K/V; ``lm_decode_step`` then carries the self-attention cache.  The
cache is ``{"self": {"k", "v"}, "cross": {"k", "v", "len"}}`` of (L, B, ...)
buffers, axis 1 the row; ``len`` (L, B) holds each row's memory length
(the JAX package keeps one scalar for the batch).  The serving engine does
not take this family (``serve/engine.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def _xattn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": cm.dense_init(gen, d, h * hd, dtype),
        "wk": cm.dense_init(gen, d, kvh * hd, dtype),
        "wv": cm.dense_init(gen, d, kvh * cfg.vhd, dtype),
        "wo": cm.dense_init(gen, h * cfg.vhd, d, dtype),
    }


def enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_dtype
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return {"ln1": zeros(), "ln2": zeros(), "attn": cm.attn_init(gen, cfg, dtype),
            "ffn": cm.ffn_init(gen, cfg, dtype=dtype)}


def dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_dtype
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return {"ln1": zeros(), "lnx": zeros(), "ln2": zeros(),
            "attn": cm.attn_init(gen, cfg, dtype), "xattn": _xattn_init(gen, cfg, dtype),
            "ffn": cm.ffn_init(gen, cfg, dtype=dtype)}


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


def enc_block_apply(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv(p["attn"], h, cfg, _positions(x))
    out = cm.flash_attention(q, k, v, causal=False)            # bidirectional
    x = x + out.reshape(b, s, -1) @ p["attn"]["wo"]
    return x + cm.ffn_apply(p["ffn"], cm.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)


def _cross_kv(p, enc_out, cfg: ModelConfig):
    b, se, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, se, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(b, se, cfg.n_kv_heads, cfg.vhd)
    return k, v


def dec_block_apply(p, x, enc_out, cfg: ModelConfig):
    b, s, _ = x.shape
    # causal self-attention
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + cm.attn_apply(p["attn"], h, cfg, positions=_positions(x))
    # cross-attention (no rope on the encoder memory)
    h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
    q = (h @ p["xattn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k, v = _cross_kv(p["xattn"], enc_out, cfg)
    out = cm.flash_attention(q, k, v, causal=False)
    x = x + out.reshape(b, s, -1) @ p["xattn"]["wo"]
    return x + cm.ffn_apply(p["ffn"], cm.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)


# ---------------------------------------------------------------------------
# model shell
# ---------------------------------------------------------------------------


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dtype = cfg.torch_dtype
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_blocks": [enc_block_init(gen, cfg) for _ in range(cfg.enc_layers)],
        "dec_blocks": [dec_block_init(gen, cfg) for _ in range(cfg.dec_layers)],
        "enc_norm": zeros(),
        "final_norm": zeros(),
        "head": cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }


def encode(p, frames, cfg: ModelConfig):
    x = frames.to(cfg.torch_dtype)
    for layer in p["enc_blocks"]:
        x = enc_block_apply(layer, x, cfg)
    return cm.rmsnorm(x, p["enc_norm"], cfg.norm_eps)


def lm_loss(p, batch, cfg: ModelConfig):
    raise NotImplementedError("lm_loss (training) is not ported yet (ROADMAP.md A13d)")


def lm_forward(p, batch, cfg: ModelConfig, *, last_only: bool = False):
    """Encoder pass and teacher-forced decoder logits (B, S_dec, padded_vocab).

    ``batch``: ``{"frames": (B, S_enc, d), "tokens": (B, S_dec)}``, or bare
    (B, S) tokens, whose frames are then zero, S of them (the JAX package's
    text-only probing path)."""
    if isinstance(batch, dict):
        frames, tokens = batch["frames"], batch["tokens"]
    else:
        tokens = batch
        frames = torch.zeros(*tokens.shape, cfg.d_model, dtype=cfg.torch_dtype,
                             device=tokens.device)
    enc_out = encode(p, frames, cfg)
    x = p["embed"][tokens]
    for layer in p["dec_blocks"]:
        x = dec_block_apply(layer, x, enc_out, cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    return x @ p["head"]


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    """Self-attention K/V, and cross K/V with each row's memory length
    (filled by ``prefill_cross``); ``max_len`` bounds both sequences."""
    shape = (cfg.dec_layers, batch, max_len, cfg.n_kv_heads)
    kv = lambda: {"k": torch.zeros(*shape, cfg.hd, dtype=cfg.torch_dtype, device=device),
                  "v": torch.zeros(*shape, cfg.vhd, dtype=cfg.torch_dtype, device=device)}
    cross = kv()
    cross["len"] = torch.zeros(cfg.dec_layers, batch, dtype=torch.int64, device=device)
    return {"self": kv(), "cross": cross}


def prefill_cross(p, cache, frames, cfg: ModelConfig):
    """Run the encoder on ``frames`` (B, S_enc, d) and fill every layer's
    cross K/V (rows past S_enc zeroed) and lengths, in place.  Returns the
    cache."""
    enc_out = encode(p, frames, cfg)
    se = enc_out.shape[1]
    cross = cache["cross"]
    for i, layer in enumerate(p["dec_blocks"]):
        k, v = _cross_kv(layer["xattn"], enc_out, cfg)
        for name, t in (("k", k), ("v", v)):
            cross[name][i].zero_()
            cross[name][i, :, :se] = t.to(cross[name].dtype)
    cross["len"].fill_(se)
    return cache


def lm_decode_step(p, cache, tokens, pos, cfg: ModelConfig):
    """One decoder step after ``prefill_cross``.  tokens: (B, 1); pos: the
    index the new token occupies, an int or a (B,) tensor; the self cache is
    written at each row's position, in place.  Returns (logits, cache)."""
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device).reshape(-1).expand(b)
    x = p["embed"][tokens]
    sc, xc = cache["self"], cache["cross"]
    for i, layer in enumerate(p["dec_blocks"]):
        h = cm.rmsnorm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = cm.attn_qkv(layer["attn"], h, cfg, pos[:, None])
        out = cm.cached_attention(q, k, v, sc["k"][i], sc["v"][i], pos)
        x = x + out.reshape(b, 1, -1) @ layer["attn"]["wo"]
        h = cm.rmsnorm(x, layer["lnx"], cfg.norm_eps)
        q = (h @ layer["xattn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
        out = cm.decode_attention(q, xc["k"][i], xc["v"][i], xc["len"][i])
        x = x + out.reshape(b, 1, -1) @ layer["xattn"]["wo"]
        x = x + cm.ffn_apply(layer["ffn"], cm.rmsnorm(x, layer["ln2"], cfg.norm_eps), cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return x @ p["head"], cache
