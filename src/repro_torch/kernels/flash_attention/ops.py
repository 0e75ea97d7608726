"""``flash_attention``: the attention of every layer of the LM, forward and backward.

On a CUDA tensor the forward launches a hand-written kernel, chosen by
dtype: bfloat16 goes to ``csrc/flash_attention_wgmma.cu`` (route
``bf16_wgmma``: Hopper's warpgroup products fed by TMA, sm_90a; persistent
blocks, one an SM, over items of 128 query rows, a producer thread keeping Q
and a ring of K and V tiles in flight and two consumer warpgroups of 64 rows;
S = Q·Kᵀ from shared memory, P rounded to bf16 in registers as the A operand
of O += P·V; float32 sums), float32 to ``csrc/flash_attention.cu`` (CUDA cores, float32
throughout, as the JAX kernel computes, in exact float32 FMAs on
register-blocked tiles fed by cp.async); any other dtype is refused.  On a
CPU tensor it runs the plain version, ``repro_torch.models.flash``.  There is
no fallback from one to the other.  GQA layout: q (B, Sq, H, hd), k (B, Sk,
KV, hd), v (B, Sk, KV, hdv), H = KV·G; the output is (B, Sq, H, hdv) in q's
dtype.

Training: when autograd records (grad enabled and q, k or v requires grad),
``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is the same kernel writing the
log-sum-exp too (``flash_attention_with_lse``) and whose backward is the
hand-written backward kernel ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``: one key-major pass, bf16 on wgmma with TMA, float32
on the CUDA cores; ``kernels/flash_attention/ref.py`` states its order); on
CPU tensors both are the plain pair of
``models/flash.py`` (``_flash_fwd_impl``, ``_flash_bwd``).  Calls that
record no gradient (the LM forward, serving) keep the forward-only launch.

Head dims.  Both bf16 kernels share one table, ``BF16_WIDTHS``
(``bf16_head_dims``): (64, 64), (128, 128), MLA's (192, 128) native, (256,
256), the least pair that holds (hd, hdv) (16, 18, 24, 32 → 64; 112 → 128).
The backward zero-pads q and k to the pair's first width, v, out and dout
to its second.  The forward reads q, k and v at their own widths (TMA
zero-fills a panel's lanes past them; ``_stored_width`` pads a width only to
a whole number of 16 bytes, 18 → 24) and writes its output at the true
hdv.  The float32 kernels are compiled for the head dims in ``HEAD_DIMS``;
any other hd, and a v head dim of its own, goes through ``pad_head_dims``:
q, k and v zero-padded to the least size of the table that holds both, the
output sliced back to hdv.  Either way the kernel gets the true
``1/sqrt(hd)`` as an argument: the padded lanes add exact zeros to q·k and to
P·V, and q is not rescaled, so no rounding is added.  The float32 backward
pads dout as v and slices the padded lanes of dq and dk off.  The bf16
backward's dq sums in a float32 workspace ``dq_acc`` (B, Sq, H, hd) in a
fixed order, under one counter per (batch, head, query tile); the wrapper
allocates both zeroed, and a finish kernel writes dq at the true head dim.
The float32 backward adds into dq itself (zeroed, at the padded width) under
the same counters.

``flash_attention.launches`` counts the forward kernel's launches on both
routes (with or without the log-sum-exp), ``flash_attention.routes`` each;
``flash_attention_bwd.launches`` and ``.routes`` count the backward's (its
kernels — delta, then dq and dk/dv, or the wgmma pass and its finish — as one
launch).

Each of the three entries (the forward, the forward with its log-sum-exp, the
backward) is a ``torch.library.custom_op`` (``repro_torch::flash_fwd``,
``flash_fwd_lse``, ``flash_bwd``) whose body is the dispatch above.  Each
has a fake (``register_fake``): on the ``meta`` device it returns empty
outputs of the right shapes and launches nothing, so a whole model step can
be traced for its shapes (``roofline/counts.py``).  Each has a FLOP formula
(``register_flop_formula``) for ``torch.utils.flop_counter.FlopCounterMode``:
the card kernel's work, the scores and P·V over the keys each query sees
(``attention_flops``), 2.5× that for the backward.  The mode counts the op
once, on the CPU as on ``meta``, and not the plain version's own products.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _lib
from repro_torch.models.flash import _flash_bwd, _flash_fwd_impl
from repro_torch.models.flash import flash_attention as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
ROUTES = {torch.bfloat16: ("bf16_wgmma", "port_flash_attention_bf16"),
          torch.float32: ("f32_cuda_cores", "port_flash_attention")}
BWD_ROUTES = {torch.bfloat16: "bf16_wgmma", torch.float32: "f32_cuda_cores"}
# the (hd, hdv) pairs of both bf16 kernels (forward and backward), in order of size
BF16_WIDTHS = ((64, 64), (128, 128), (192, 128), (256, 256))
# query rows of a tile of either backward route (its dq counters are one a tile)
BWD_QUERY_TILE = 64
# the plain pair's blocks (models/flash.py's defaults)
PLAIN_BLOCKS = (512, 1024)


def padded_head_dim(hd: int, hdv: int) -> int:
    """The kernel's head dim for (hd, hdv): the least of ``HEAD_DIMS`` that
    holds both."""
    for width in HEAD_DIMS:
        if width >= max(hd, hdv):
            return width
    raise ValueError(f"flash_attention: head dims {hd}, {hdv} exceed {HEAD_DIMS[-1]}")


def bf16_head_dims(hd: int, hdv: int) -> Tuple[int, int]:
    """The bf16 kernels' (hd, hdv) for a head dim pair: the first of
    ``BF16_WIDTHS`` that holds both (MLA's (192, 128) natively)."""
    for width, vwidth in BF16_WIDTHS:
        if width >= hd and vwidth >= hdv:
            return width, vwidth
    raise ValueError(f"flash_attention: head dims {hd}, {hdv} exceed {BF16_WIDTHS[-1]}")


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _stored_width(n: int, width: int) -> int:
    """The width the bf16 forward reads a head dim n at, for a kernel width:
    TMA reads the tensor in place and zero-fills a 64-column panel's lanes past
    it, so n is padded only to a whole number of 16 bytes, or to the kernel's
    width where its last panel would lie wholly past n."""
    n8 = -(-n // 8) * 8
    return n8 if n8 > width - 64 else width


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float, int]:
    """(q, k, v zero-padded to ``padded_head_dim``, the true softmax scale
    ``1/sqrt(hd)``, hdv): attention of the padded triple at that scale,
    sliced to ``[..., :hdv]``, is the attention of the unpadded one."""
    hd, hdv = q.shape[-1], v.shape[-1]
    width = padded_head_dim(hd, hdv)
    return _pad(q, width), _pad(k, width), _pad(v, width), 1.0 / math.sqrt(hd), hdv


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Refuse shapes and dtypes the kernels do not take (on any device)."""
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Refuse what the kernels do not take."""
    _check_args(q, k, v, *more)
    _lib.require_cuda("flash_attention", q, k, v, *more)
    if any(t.data_ptr() % 16 for t in (q, k, v) + more):
        raise ValueError("flash_attention: expected 16-byte aligned tensors")


def _forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward kernel on CUDA tensors: (out (B, Sq, H, hdv), the
    log-sum-exp (B, KV, G, Sq) float32 or None)."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kvh, hdv = k.shape[1], k.shape[2], v.shape[-1]
    route, entry = ROUTES[q.dtype]
    lse = (torch.empty((b, kvh, h // kvh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if route == "bf16_wgmma":
        width, vwidth = bf16_head_dims(hd, hdv)
        qk_w, v_w = _stored_width(hd, width), _stored_width(hdv, vwidth)
        q, k, v = _pad(q, qk_w), _pad(k, qk_w), _pad(v, v_w)
        out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
        widths = (width, vwidth, qk_w, v_w, hdv)
        scale = 1.0 / math.sqrt(hd)
    else:
        q, k, v, scale, hdv = pad_head_dims(q, k, v)
        out = torch.empty_like(q)
        widths = (q.shape[-1],)
    code = getattr(_lib.library(), entry)(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(out), _lib.ptr(lse), b, sq, sk, h, kvh,
        *widths, int(causal), int(window), scale, _lib.stream())
    _lib.check(code, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return (out if out.shape[-1] == hdv else out[..., :hdv].contiguous()), lse


@torch.library.custom_op("repro_torch::flash_fwd_lse", mutates_args=())
def _flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                   window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _flash_fwd_impl(q, k, v, causal, window, *PLAIN_BLOCKS)
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, the log-sum-exp (B, KV, G, Sq) float32): the forward kernel with
    its log-sum-exp output on CUDA tensors, the plain forward on CPU ones."""
    return _flash_fwd_lse(q, k, v, causal, window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype: the backward kernel on CUDA
    tensors, the plain ``_flash_bwd`` on CPU ones.  ``out`` and ``lse`` are
    the forward's (``flash_attention_with_lse``)."""
    return _flash_bwd_op(q, k, v, out, dout, lse, causal, window)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, causal: bool, window: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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
    route = BWD_ROUTES[q.dtype]
    hdv = v.shape[-1]
    counters = torch.zeros(1 + b * h * -(-sq // BWD_QUERY_TILE), dtype=torch.int32,
                           device=q.device)
    if route == "bf16_wgmma":
        width, vwidth = bf16_head_dims(hd, hdv)
        qp, kp = _pad(q, width), _pad(k, width)
        vp, outp, doutp = _pad(v, vwidth), _pad(out, vwidth), _pad(dout, vwidth)
        scale = 1.0 / math.sqrt(hd)
        dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
        dq_acc = torch.zeros((b, sq, h, width), dtype=torch.float32, device=q.device)
    else:
        qp, kp, vp, scale, _ = pad_head_dims(q, k, v)
        width = vwidth = qp.shape[-1]
        outp, doutp = _pad(out, width), _pad(dout, width)
        dq, dq_acc = torch.zeros_like(qp), None
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    code = _lib.library().port_flash_attention_bwd(
        _lib.ptr(qp), _lib.ptr(kp), _lib.ptr(vp), _lib.ptr(outp), _lib.ptr(doutp),
        _lib.ptr(lse), _lib.ptr(delta), _lib.ptr(dq), _lib.ptr(dk), _lib.ptr(dv),
        _lib.ptr(dq_acc), _lib.ptr(counters), b, sq, sk, h, kvh, width, vwidth, hd,
        int(causal), int(window), scale, int(route == "bf16_wgmma"), _lib.stream())
    _lib.check(code, f"flash_attention_bwd ({route})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    if dq.shape[-1] != hd:
        dq = dq[..., :hd].contiguous()
    if width != hd:
        dk = dk[..., :hd].contiguous()
    return dq, dk, (dv if vwidth == hdv else dv[..., :hdv].contiguous())


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


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _flash_fwd(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}


# ---------------------------------------------------------------------------
# shapes on ``meta`` and FLOPs for ``FlopCounterMode``
# ---------------------------------------------------------------------------


def _out_like(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return q.new_empty(q.shape[:3] + v.shape[3:])


@_flash_fwd.register_fake
def _(q, k, v, causal, window):
    _check_args(q, k, v)
    return _out_like(q, v)


@_flash_fwd_lse.register_fake
def _(q, k, v, causal, window):
    _check_args(q, k, v)
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    return _out_like(q, v), q.new_empty((b, kvh, h // kvh, sq), dtype=torch.float32)


@_flash_bwd_op.register_fake
def _(q, k, v, out, dout, lse, causal, window):
    _check_args(q, k, v, out, dout)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def keys_seen(sq: int, sk: int, causal: bool, window: int) -> int:
    """Σ over the Sq queries of the keys each one attends to: query i sees
    keys [max(i − window + 1, 0), min(i + 1, Sk)) when causal, all Sk
    otherwise."""
    qpos = np.arange(sq, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(q_shape, k_shape, v_shape, causal: bool, window: int) -> int:
    """The forward's work: 2·hd a key for the scores and 2·hdv for P·V, over
    the keys each query of each head sees (unpadded head dims)."""
    b, sq, h, hd = q_shape
    sk, hdv = k_shape[1], v_shape[3]
    return 2 * b * h * (hd + hdv) * keys_seen(sq, sk, causal, window)


@register_flop_formula([torch.ops.repro_torch.flash_fwd, torch.ops.repro_torch.flash_fwd_lse])
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, v_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, v_shape, out_shape_, dout_shape, lse_shape, causal, window, *args,
      out_shape=None, **kwargs) -> int:
    return 5 * attention_flops(q_shape, k_shape, v_shape, causal, window) // 2
