"""Plain PyTorch versions of the ``ell_matvec`` and ``ell_rmatvec`` kernels.

Semantics (as ``repro/kernels/spmv/ref.py``): ``indices``/``values`` are the
(N, K) padded CSR, each row padded with ``index = 0, value = 0``;
``matvec``: ``out[i] = Σ_k values[i,k]·w[indices[i,k]]`` → (N,);
``rmatvec``: ``out[j] = Σ_{i,k: indices[i,k]=j} values[i,k]·q[i]`` → (D,).
On the CPU, ``index_add_`` adds in row order, the order of the TPU kernel's
sequential scatter and of the CUDA kernel's column walk.
"""
from __future__ import annotations

import torch


def ell_matvec_ref(indices: torch.Tensor, values: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    return (values * w[indices.long()]).sum(dim=1)


def ell_rmatvec_ref(indices: torch.Tensor, values: torch.Tensor, q: torch.Tensor,
                    d: int) -> torch.Tensor:
    contrib = values * q[:, None]
    out = torch.zeros(d, dtype=values.dtype, device=values.device)
    return out.index_add_(0, indices.reshape(-1).long(), contrib.reshape(-1))
