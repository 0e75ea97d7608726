"""``tile_products``: the wgmma backward's tile helpers held on their own.

``csrc/wgmma_tile_check.cu`` runs, on one warpgroup, the three kinds of
product the bf16 backward (``csrc/flash_attention_bwd.cu``) is built from, on
tiles loaded by TMA into 128-byte-swizzled panels, over several key tiles at
head dim 64: for q, dout (64, 64) and k (nk·64, 64) in bf16, with k_j the
j-th 64-row tile of k,

    s_j = k_j · qᵀ                    (nk, 64, 64) float32
    y   = Σ_j bf16(s_j) · dout        (64, 64) float32
    z   = Σ_j bf16(s_j)ᵀ · k_j        (64, 64) float32

It replaces no Pallas kernel and runs on no path; the card's tests hold it
against ``torch.matmul`` (this module's plain version, taken for CPU tensors).
``tile_products.launches`` counts its launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib

TILE = 64


def tile_products_plain(q: torch.Tensor, k: torch.Tensor, dout: torch.Tensor,
                        s: torch.Tensor = None) -> Tuple[torch.Tensor, ...]:
    """(s, y, z) by ``torch.matmul`` in float32; ``s`` given: y and z from its
    bf16 rounding (so that they see the kernel's own s)."""
    kt = k.float().reshape(-1, TILE, TILE)
    if s is None:
        s = kt @ q.float().T
    p = s.to(torch.bfloat16).float()
    y = (p @ dout.float()).sum(0)
    z = (p.transpose(1, 2) @ kt).sum(0)
    return s, y, z


def tile_products(q: torch.Tensor, k: torch.Tensor, dout: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, y, z) above: the kernel on CUDA tensors, the plain version on CPU
    ones."""
    if q.shape != (TILE, TILE) or dout.shape != (TILE, TILE) or k.dim() != 2 \
            or k.shape[1] != TILE or k.shape[0] % TILE or k.shape[0] == 0:
        raise ValueError(f"tile_products: q {tuple(q.shape)}, k {tuple(k.shape)}, dout "
                         f"{tuple(dout.shape)}; expected (64, 64), (nk*64, 64), (64, 64)")
    if any(t.dtype != torch.bfloat16 for t in (q, k, dout)):
        raise ValueError("tile_products: expected bfloat16 tensors")
    if q.device.type == "cpu":
        return tile_products_plain(q, k, dout)
    _lib.require_cuda("tile_products", q, k, dout)
    nk = k.shape[0] // TILE
    s = torch.empty((nk, TILE, TILE), dtype=torch.float32, device=q.device)
    y = torch.empty((TILE, TILE), dtype=torch.float32, device=q.device)
    z = torch.empty_like(y)
    code = _lib.library().port_wgmma_tile_check(_lib.ptr(q), _lib.ptr(k), _lib.ptr(dout), nk,
                                                _lib.ptr(s), _lib.ptr(y), _lib.ptr(z),
                                                _lib.stream())
    _lib.check(code, "tile_products")
    tile_products.launches += 1
    return s, y, z


tile_products.launches = 0
