"""``flash_attention``: the attention forward of every layer of the LM forward.

On a CUDA tensor it launches a hand-written kernel, chosen by dtype:
bfloat16 goes to ``csrc/flash_attention_mma.cu`` (tensor cores, float32
sums, P rounded to bf16 before P·V), float32 to ``csrc/flash_attention.cu``
(CUDA cores, float32 throughout, as the JAX kernel computes); any other
dtype is refused.  On a CPU tensor it runs the plain version,
``repro_torch.models.flash.flash_attention``.  There is no fallback from one
to the other.  GQA layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), H = KV·G;
the output has q's shape and dtype.

``flash_attention.launches`` counts both routes; ``flash_attention.routes``
counts each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.models.flash import flash_attention as flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
ROUTES = {torch.bfloat16: ("bf16_tensor_cores", "port_flash_attention_bf16"),
          torch.float32: ("f32_cuda_cores", "port_flash_attention")}


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
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "expected one of float32 or bfloat16 for all three")
    _lib.require_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: expected 16-byte aligned tensors")
    route, entry = ROUTES[q.dtype]
    out = torch.empty_like(q)
    code = getattr(_lib.library(), entry)(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(out), b, sq, sk, h, kvh, hd,
        int(causal), int(window), _lib.stream())
    _lib.check(code, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}
