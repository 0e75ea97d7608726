"""``flash_attention``: the attention of every layer of the LM, forward and backward.

On a CUDA tensor the forward launches a hand-written kernel, chosen by
dtype: bfloat16 goes to ``csrc/flash_attention_mma.cu`` (tensor cores,
float32 sums, P rounded to bf16 before P·V), float32 to
``csrc/flash_attention.cu`` (CUDA cores, float32 throughout, as the JAX
kernel computes); any other dtype is refused.  On a CPU tensor it runs the
plain version, ``repro_torch.models.flash``.  There is no fallback from one
to the other.  GQA layout: q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk,
KV, hdv), H = KV·G; the output is (B, Sq, H, hdv) in q's dtype.

Training: when autograd records (grad enabled and q, k or v requires grad),
``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is the same kernel writing the
log-sum-exp too (``flash_attention_with_lse``) and whose backward is the
hand-written backward kernel ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``: bf16 on the tensor cores, float32 on the CUDA
cores); on CPU tensors both are the plain pair of
``models/flash.py`` (``_flash_fwd_impl``, ``_flash_bwd``).  Calls that
record no gradient (the LM forward, serving) keep the forward-only launch.

The kernels are compiled for the head dims in ``HEAD_DIMS``.  Any other hd,
and a v head dim of its own (MLA's 192 against 128), goes through
``pad_head_dims``: q and k are zero-padded to the next size in the table
that holds both hd and hdv, v to the same width, the kernel gets the true
``1/sqrt(hd)`` as an argument, and the output is sliced back to hdv.  The
padded lanes add exact zeros to q·k and to P·V, and q is not rescaled, so
no rounding is added; hd 64 gives the bits it gave before the padding
existed (``1/sqrt(64)`` is exact).  The backward pads dout as v and slices
the padded lanes of dq and dk off.

``flash_attention.launches`` counts the forward kernel's launches on both
routes (with or without the log-sum-exp), ``flash_attention.routes`` each;
``flash_attention_bwd.launches`` and ``.routes`` count the backward's (its
three kernels — delta, dq, dk/dv — as one launch).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.models.flash import _flash_bwd, _flash_fwd_impl
from repro_torch.models.flash import flash_attention as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
ROUTES = {torch.bfloat16: ("bf16_tensor_cores", "port_flash_attention_bf16"),
          torch.float32: ("f32_cuda_cores", "port_flash_attention")}
BWD_ROUTES = {torch.bfloat16: "bf16_tensor_cores", torch.float32: "f32_cuda_cores"}
# the plain pair's blocks (models/flash.py's defaults)
PLAIN_BLOCKS = (512, 1024)


def padded_head_dim(hd: int, hdv: int) -> int:
    """The kernel's head dim for (hd, hdv): the least of ``HEAD_DIMS`` that
    holds both."""
    for width in HEAD_DIMS:
        if width >= max(hd, hdv):
            return width
    raise ValueError(f"flash_attention: head dims {hd}, {hdv} exceed {HEAD_DIMS[-1]}")


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float, int]:
    """(q, k, v zero-padded to ``padded_head_dim``, the true softmax scale
    ``1/sqrt(hd)``, hdv): attention of the padded triple at that scale,
    sliced to ``[..., :hdv]``, is the attention of the unpadded one."""
    hd, hdv = q.shape[-1], v.shape[-1]
    width = padded_head_dim(hd, hdv)
    return _pad(q, width), _pad(k, width), _pad(v, width), 1.0 / math.sqrt(hd), hdv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Refuse what the kernels do not take."""
    b, _, h, hd = q.shape
    bk, _, kvh, hdk = k.shape
    if (k.shape[:3] != v.shape[:3] or v.dim() != 4 or bk != b or hdk != hd or kvh == 0
            or h % kvh):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not a GQA triple")
    padded_head_dim(hd, v.shape[-1])                  # refuses widths past the table
    if q.dtype not in ROUTES or any(t.dtype != q.dtype for t in (k, v) + more):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "expected one of float32 or bfloat16 for all of them")
    _lib.require_cuda("flash_attention", q, k, v, *more)
    if any(t.data_ptr() % 16 for t in (q, k, v) + more):
        raise ValueError("flash_attention: expected 16-byte aligned tensors")


def _forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward kernel on CUDA tensors: (out (B, Sq, H, hdv), the
    log-sum-exp (B, KV, G, Sq) float32 or None)."""
    _check(q, k, v)
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    q, k, v, scale, hdv = pad_head_dims(q, k, v)
    route, entry = ROUTES[q.dtype]
    out = torch.empty_like(q)
    lse = (torch.empty((b, kvh, h // kvh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    code = getattr(_lib.library(), entry)(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(out), _lib.ptr(lse), b, sq, sk, h, kvh,
        q.shape[-1], int(causal), int(window), scale, _lib.stream())
    _lib.check(code, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return (out if out.shape[-1] == hdv else out[..., :hdv].contiguous()), lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, the log-sum-exp (B, KV, G, Sq) float32): the forward kernel with
    its log-sum-exp output on CUDA tensors, the plain forward on CPU ones."""
    if q.device.type == "cpu":
        return _flash_fwd_impl(q, k, v, causal, window, *PLAIN_BLOCKS)
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype: the backward kernel on CUDA
    tensors, the plain ``_flash_bwd`` on CPU ones.  ``out`` and ``lse`` are
    the forward's (``flash_attention_with_lse``)."""
    if q.device.type == "cpu":
        return _flash_bwd(causal, window, *PLAIN_BLOCKS, (q, k, v, out, lse), dout)
    dout = dout.contiguous()
    _check(q, k, v, out, dout)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if out.shape != dout.shape or out.shape[:3] != q.shape[:3] or out.shape[3] != v.shape[3]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} against q {tuple(q.shape)}, v {tuple(v.shape)}")
    if lse.shape != (b, kvh, h // kvh, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}, expected "
                         f"{(b, kvh, h // kvh, sq)} float32")
    _lib.require_cuda("flash_attention_bwd", lse)
    qp, kp, vp, scale, hdv = pad_head_dims(q, k, v)
    width = qp.shape[-1]
    outp, doutp = _pad(out, width), _pad(dout, width)
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = BWD_ROUTES[q.dtype]
    code = _lib.library().port_flash_attention_bwd(
        _lib.ptr(qp), _lib.ptr(kp), _lib.ptr(vp), _lib.ptr(outp), _lib.ptr(doutp),
        _lib.ptr(lse), _lib.ptr(delta), _lib.ptr(dq), _lib.ptr(dk), _lib.ptr(dv), b, sq, sk, h,
        kvh, width, int(causal), int(window), scale, int(q.dtype == torch.bfloat16),
        _lib.stream())
    _lib.check(code, f"flash_attention_bwd ({route})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    if width != hd:
        dq, dk = dq[..., :hd].contiguous(), dk[..., :hd].contiguous()
    return dq, dk, (dv if width == hdv else dv[..., :hdv].contiguous())


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(BWD_ROUTES.values(), 0)


class FlashAttention(torch.autograd.Function):
    """Attention with its hand-written backward (the JAX package's custom
    VJP): saves q, k, v, out and the log-sum-exp, never P."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}
