"""Mamba-1 (selective SSM) LM, the falcon-mamba-7b family (port of ``repro.models.mamba``).

The selective scan runs chunk-parallel, as in the JAX package: the sequence
is cut into chunks (``nc = max(1, S // 256)`` of ``S // nc`` steps), an
inclusive scan over (a, b) pairs with (a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂) runs
inside each chunk in log₂ steps, and a loop carries the (B, d_inner, N)
state across chunks.  ``dA = exp(dt·A)`` and ``dBx = dt·x·B`` are formed one
chunk at a time, so the float32 (B, S, d_inner, N) tensors the JAX package
builds whole (4.29 GB each at falcon-mamba's width, B = 4, S = 2,048) never
exist; the values are the same.  The scan is plain torch ops, as it is pure
JAX there (no Pallas kernel); everything in it is float32.

Decode carries (conv window, SSM state) per layer, O(1) a token, no KV
cache: ``{"main": {"h": (L, B, d_inner, N) float32, "conv": (L, B, K − 1,
d_inner)}}``, axis 1 the slot as every cache of the port, written in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _logits, loss_targets, remat_call

CHUNK = 256

Params = Dict[str, Any]


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype = cfg.torch_dtype
    d, di, r, n, k = cfg.d_model, cfg.d_inner, cfg.dt_rank_, cfg.ssm_state, cfg.conv_kernel
    dev = gen.device
    # S4D-real initialization for A; dt = exp(u), u ~ U(log 1e-3, log 1e-1), through softplus⁻¹
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n)
    u = torch.empty(di, dtype=torch.float32, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    dt_bias = torch.log(torch.exp(torch.exp(u)) - 1.0 + 1e-9)
    return {
        "ln": torch.zeros(d, dtype=dtype, device=dev),
        "in_proj": cm.dense_init(gen, d, 2 * di, dtype),
        "conv_w": cm._trunc_normal(gen, (k, di), 1.0 / math.sqrt(k), dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": cm.dense_init(gen, di, r + 2 * n, dtype),
        "dt_proj": cm.dense_init(gen, r, di, dtype, scale=r ** -0.5),
        "dt_bias": dt_bias,
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": cm.dense_init(gen, di, d, dtype),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, di); w: (K, di); state: (B, K − 1,
    di), the previous inputs, carried for decode.  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S + K − 1, di)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return y + b[None, None, :], xp[:, -(k - 1):, :]


def chunk_len(s: int) -> int:
    """The scan's chunk for a sequence of ``s``: ``s // max(1, s // 256)``.
    A length it does not divide is refused, as the JAX package refuses it."""
    ck = s // max(1, s // CHUNK)
    if s % ck:
        raise ValueError(f"scan: sequence length {s} is not a multiple of its chunk {ck} "
                         f"(chunks of ~{CHUNK})")
    return ck


def scan_chunk(a, b, h):
    """One chunk of the linear recurrence h_t = a_t·h_{t−1} + b_t along axis
    1: a log-step inclusive scan of (a, b) under (a₁a₂, a₂b₁ + b₂), then
    h_t = a_cum·h + b_cum.  a, b: (B, ck, ...); h: (B, ...).  Returns every
    h_t, (B, ck, ...).

    Two bodies of the same ops and bits: ``torch.cat`` when autograd
    records, ``out=`` stores into fresh buffers otherwise (autograd cannot
    record ``out=``).  Each is faster than one body of slice stores, which
    forms a temporary and copies it a product (``tools/time_mamba_scan.py``
    times the three; ``PERF.md`` §6)."""
    n, step = a.shape[1], 1
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or h.requires_grad)
    while step < n:
        if grad:
            a_next = torch.cat([a[:, :step], torch.mul(a[:, :-step], a[:, step:])], dim=1)
            b_next = torch.cat([b[:, :step], torch.addcmul(b[:, step:], a[:, step:],
                                                           b[:, :-step])], dim=1)
        else:
            a_next, b_next = torch.empty_like(a), torch.empty_like(b)
            a_next[:, :step], b_next[:, :step] = a[:, :step], b[:, :step]
            torch.mul(a[:, :-step], a[:, step:], out=a_next[:, step:])
            torch.addcmul(b[:, step:], a[:, step:], b[:, :-step], out=b_next[:, step:])
        a, b = a_next, b_next
        step *= 2
    return torch.addcmul(b, a, h[:, None])


def _ssm_inputs(p, xc, cfg: ModelConfig):
    """The scan's per-token inputs from the conv output xc (B, S, di), all
    float32: (dt (B, S, di), A (di, N), B (B, S, N), C (B, S, N)).
    ``_ssm_chunked`` forms dA = exp(dt·A) and dBx = dt·x·B from them."""
    r, n = cfg.dt_rank_, cfg.ssm_state
    proj = xc @ p["x_proj"]                               # (B, S, r + 2N)
    dt_r, b_mat, c_mat = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float() + p["dt_bias"])
    return dt, -torch.exp(p["a_log"]), b_mat.float(), c_mat.float()


def _ssm_chunked(dt, x, a, b_mat, c, h0):
    """Chunk-parallel selective scan.

    dt, x: (B, S, di) float32; a: (di, N); b_mat, c: (B, S, N); h0: (B, di,
    N), the initial state.  Returns y (B, S, di) and the final state.
    """
    s = dt.shape[1]
    ck = chunk_len(s)
    h, ys = h0, []
    for lo in range(0, s, ck):
        dt_c = dt[:, lo:lo + ck, :, None]                                # (B, ck, di, 1)
        d_a = torch.exp(dt_c * a)                                        # (B, ck, di, N)
        d_bx = (dt_c * x[:, lo:lo + ck, :, None]) * b_mat[:, lo:lo + ck, None, :]
        h_t = scan_chunk(d_a, d_bx, h)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_t, c[:, lo:lo + ck]))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def _mixer_in(p, x, cfg: ModelConfig, conv_state):
    """Norm, in-projection and causal conv: (xc, z, new conv state)."""
    di = cfg.d_inner
    xz = cm.rmsnorm(x, p["ln"], cfg.norm_eps) @ p["in_proj"]
    xc, conv_state = _causal_conv(xz[..., :di], p["conv_w"], p["conv_b"], conv_state)
    return F.silu(xc), xz[..., di:], conv_state


def _mixer_out(p, res, y, xc, z):
    y = y + p["d_skip"][None, None] * xc.float()
    y = (y * F.silu(z.float())).to(res.dtype)
    return res + y @ p["out_proj"]


def block_apply(p, x, cfg: ModelConfig, h0=None, conv_state=None):
    """Full-sequence mamba block.  Returns (x_out, (h_final, conv_state))."""
    xc, z, conv_state = _mixer_in(p, x, cfg, conv_state)
    dt, a, b_mat, c = _ssm_inputs(p, xc, cfg)
    if h0 is None:
        h0 = torch.zeros(x.shape[0], cfg.d_inner, cfg.ssm_state, dtype=torch.float32,
                         device=x.device)
    y, h_final = _ssm_chunked(dt, xc.float(), a, b_mat, c, h0)
    return _mixer_out(p, x, y, xc, z), (h_final, conv_state)


def block_decode(p, x, cache, cfg: ModelConfig):
    """One-token step.  cache = {"h": (B, di, N) float32, "conv": (B, K − 1,
    di)}, this layer's rows, written in place.  Returns (x, cache)."""
    xc, z, conv_state = _mixer_in(p, x, cfg, cache["conv"])
    dt, a, b_mat, c = _ssm_inputs(p, xc, cfg)             # S = 1
    dt0 = dt[:, 0, :, None]
    h = torch.exp(dt0 * a) * cache["h"] + (dt0 * xc[:, 0, :, None].float()) * b_mat[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return _mixer_out(p, x, y, xc, z), cache


# ---------------------------------------------------------------------------
# LM shell
# ---------------------------------------------------------------------------


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dtype = cfg.torch_dtype
    p: Params = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=gen.device),
        "blocks": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    return p


def lm_loss(p, batch, cfg: ModelConfig, *, remat: bool = True):
    """Causal LM loss (float32), each block recomputed in the backward when
    ``remat``; batch = {"tokens": (B, S) int}."""
    tokens = batch["tokens"]
    x = p["embed"][tokens]
    run = lambda layer, h: block_apply(layer, h, cfg)[0]
    for layer in p["blocks"]:
        x = remat_call(run, layer, x, remat=remat)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    targets, mask = loss_targets(tokens)
    head = p["embed"] if cfg.tie_embeddings else p["head"]
    return cm.ce_loss(x, head, targets, mask, cfg.vocab, cfg.padded_vocab,
                      tied=cfg.tie_embeddings)


def lm_forward(p, tokens, cfg: ModelConfig, *, last_only: bool = False):
    """Sequence logits (B, S, padded_vocab), or the last position's."""
    x = p["embed"][tokens]
    for layer in p["blocks"]:
        x, _ = block_apply(layer, x, cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    return _logits(p, x, cfg)


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    del max_len  # the state's size does not grow with the sequence
    return {"main": {
        "h": torch.zeros(cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state, dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(cfg.n_layers, batch, cfg.conv_kernel - 1, cfg.d_inner,
                            dtype=cfg.torch_dtype, device=device)}}


def lm_decode_step(p, cache, tokens, pos, cfg: ModelConfig):
    """One decode step; tokens (B, 1).  The recurrence is position-free, so
    ``pos`` is ignored.  Updates ``cache`` in place; returns (logits, cache)."""
    del pos
    x = p["embed"][tokens]
    bufs = cache["main"]
    for i, layer in enumerate(p["blocks"]):
        x, _ = block_decode(layer, x, {name: buf[i] for name, buf in bufs.items()}, cfg)
    x = cm.rmsnorm(x, p["final_norm"], cfg.norm_eps)
    return _logits(p, x, cfg), cache
