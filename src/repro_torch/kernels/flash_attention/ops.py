"""``flash_attention``: the attention forward of every layer of the LM forward.

On a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention.cu``; on a CPU tensor it runs the plain version,
``repro_torch.models.flash.flash_attention``.  There is no fallback from one
to the other.  GQA layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), H = KV·G;
the output has q's shape and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.models.flash import flash_attention as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    b, sq, h, hd = q.shape
    bk, sk, kvh, hdk = k.shape
    if k.shape != v.shape or bk != b or hdk != hd or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not a GQA triple")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "expected one of float32 or bfloat16 for all three")
    _lib.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    code = _lib.library().port_flash_attention(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(out), b, sq, sk, h, kvh, hd,
        int(causal), int(window), _DTYPES[q.dtype], _lib.stream())
    _lib.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
