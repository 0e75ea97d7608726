"""Building blocks of the dense LM (port of ``repro.models.common``).

Parameters are plain dicts of tensors keyed as the JAX package's pytrees,
weights in ``(d_in, d_out)`` orientation, so ``x @ w`` reads as in JAX.
Init functions draw from an explicit ``torch.Generator`` on the target
device; ``*_apply`` functions are plain tensor functions.  Attention in the
token-parallel forward goes through the flash-attention kernel op, which
launches the hand-written kernel on CUDA tensors and runs the plain
blockwise version (``models/flash.py``) on CPU tensors.

Only what the dense family (llama-style GQA + SwiGLU) needs is here; the
chunked CE loss, MoE, ``blocked_attention`` and the sharding constraint
come with later slices (ROADMAP A13).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

NEG = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _trunc_normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


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


def decode_attention(q, k_cache, v_cache, kv_len, *, window: int = 0):
    """Single-position attention over a padded KV cache.

    q: (B, 1, H, hd); caches: (B, S_max, KV, hd); kv_len: live length
    (including the current token), an int or a (B,) tensor of one length per
    row — the serving engine's slots sit at different positions.  Window > 0
    restricts each row to its trailing window.
    """
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kv, g, hd).float(),
                     k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)   # (B or 1, 1)
    mask = pos[None, :] < kv_len
    if window:
        mask &= pos[None, :] >= kv_len - window
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


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
