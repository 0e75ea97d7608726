"""``ell_rmatvec``: Xᵀ·q for the Frank-Wolfe setup sweep.

On a CUDA tensor it launches the column-gather kernel
(``csrc/ell_rmatvec.cu``), which walks the ``PaddedCSC``; on a CPU tensor it
runs the plain version over the ``PaddedCSR``.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse.formats import PaddedCSR
from repro_torch.kernels import _lib
from repro_torch.kernels.spmv.ref import ell_rmatvec_ref


def ell_rmatvec(X: PaddedCSR, q: torch.Tensor, pcsc=None) -> torch.Tensor:
    """Xᵀ·q; ``pcsc`` (a PaddedCSC or TieredCSC of the same X) is required on CUDA."""
    d = X.shape[1]
    if q.device.type == "cpu":
        return ell_rmatvec_ref(X.indices, X.values, q, d)
    if pcsc is None:
        raise ValueError("ell_rmatvec on CUDA gathers over the padded CSC; pass pcsc")
    if q.dtype != torch.float32 or q.shape != (X.shape[0],):
        raise ValueError(f"ell_rmatvec: q must be float32 of shape ({X.shape[0]},)")
    _lib.require_cuda("ell_rmatvec", q)
    cols = _lib.col_table(pcsc)
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    code = _lib.library().port_ell_rmatvec(*cols, _lib.ptr(q), _lib.ptr(out), d,
                                           _lib.stream())
    _lib.check(code, "ell_rmatvec")
    ell_rmatvec.launches += 1
    return out


ell_rmatvec.launches = 0
