"""``flash_attention``: the attention forward of every layer of the LM forward.

On a CUDA tensor it launches a hand-written kernel, chosen by dtype:
bfloat16 goes to ``csrc/flash_attention_mma.cu`` (tensor cores, float32
sums, P rounded to bf16 before P·V), float32 to ``csrc/flash_attention.cu``
(CUDA cores, float32 throughout, as the JAX kernel computes); any other
dtype is refused.  On a CPU tensor it runs the plain version,
``repro_torch.models.flash.flash_attention``.  There is no fallback from one
to the other.  GQA layout: q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk,
KV, hdv), H = KV·G; the output is (B, Sq, H, hdv) in q's dtype.

The kernels are compiled for the head dims in ``HEAD_DIMS``.  Any other hd,
and a v head dim of its own (MLA's 192 against 128), goes through
``pad_head_dims``: q and k are zero-padded to the next size in the table
that holds both hd and hdv, v to the same width, the kernel gets the true
``1/sqrt(hd)`` as an argument, and the output is sliced back to hdv.  The
padded lanes add exact zeros to q·k and to P·V, and q is not rescaled, so
no rounding is added; hd 64 gives the bits it gave before the padding
existed (``1/sqrt(64)`` is exact).

``flash_attention.launches`` counts both routes; ``flash_attention.routes``
counts each.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.models.flash import flash_attention as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
ROUTES = {torch.bfloat16: ("bf16_tensor_cores", "port_flash_attention_bf16"),
          torch.float32: ("f32_cuda_cores", "port_flash_attention")}


def padded_head_dim(hd: int, hdv: int) -> int:
    """The kernel's head dim for (hd, hdv): the least of ``HEAD_DIMS`` that
    holds both."""
    for width in HEAD_DIMS:
        if width >= max(hd, hdv):
            return width
    raise ValueError(f"flash_attention: head dims {hd}, {hdv} exceed {HEAD_DIMS[-1]}")


def pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float, int]:
    """(q, k, v zero-padded to ``padded_head_dim``, the true softmax scale
    ``1/sqrt(hd)``, hdv): attention of the padded triple at that scale,
    sliced to ``[..., :hdv]``, is the attention of the unpadded one."""
    hd, hdv = q.shape[-1], v.shape[-1]
    width = padded_head_dim(hd, hdv)
    pad = lambda t: t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
    return pad(q), pad(k), pad(v), 1.0 / math.sqrt(hd), hdv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    b, sq, h, hd = q.shape
    bk, sk, kvh, hdk = k.shape
    if (k.shape[:3] != v.shape[:3] or v.dim() != 4 or bk != b or hdk != hd or kvh == 0
            or h % kvh):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not a GQA triple")
    padded_head_dim(hd, v.shape[-1])                  # refuses widths past the table
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "expected one of float32 or bfloat16 for all three")
    _lib.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: expected 16-byte aligned tensors")
    q, k, v, scale, hdv = pad_head_dims(q, k, v)
    route, entry = ROUTES[q.dtype]
    out = torch.empty_like(q)
    code = getattr(_lib.library(), entry)(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(out), b, sq, sk, h, kvh, q.shape[-1],
        int(causal), int(window), scale, _lib.stream())
    _lib.check(code, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out if out.shape[-1] == hdv else out[..., :hdv].contiguous()


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}
