"""``ell_matvec`` (X·w) and ``ell_rmatvec`` (Xᵀ·q) over the padded layouts.

``ell_matvec`` gives the margins of every Alg 1 step; ``ell_rmatvec`` the
Frank-Wolfe setup sweep and every Alg 1 step's gradient.  On a CUDA tensor
each launches its kernel: ``csrc/ell_matvec.cu`` (a group of lanes per
``PaddedCSR`` row, several rows a warp) and ``csrc/ell_rmatvec.cu`` (a warp per segment of ``SEGMENT`` entries
of a ``PaddedCSC`` column); on a CPU tensor each runs its plain version over
the ``PaddedCSR``.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse.formats import PaddedCSR
from repro_torch.kernels import _lib
from repro_torch.kernels.spmv.ref import SEGMENT, ell_matvec_ref, ell_rmatvec_ref, segments


def ell_matvec(X: PaddedCSR, w: torch.Tensor, *, lanes: int = 0,
               blocks: int = 0) -> torch.Tensor:
    """X·w, (N,) float32.  ``lanes`` (4, 8, 16 or 32 lanes a row) and ``blocks``
    (a grid that strides over the rows) pick another of the kernel's shapes
    than its default (0: the source's choice); the sums do not depend on
    ``blocks``."""
    n, d = X.shape
    if lanes not in (0, 4, 8, 16, 32) or blocks < 0:
        raise ValueError(f"ell_matvec: lanes must be 0, 4, 8, 16 or 32 and blocks >= 0, "
                         f"got {lanes}, {blocks}")
    if w.device.type == "cpu":
        return ell_matvec_ref(X.indices, X.values, w)
    if w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(f"ell_matvec: w must be float32 of shape ({d},)")
    if X.indices.dtype != torch.int32 or X.values.dtype != torch.float32 or \
            X.nnz.dtype != torch.int32:
        raise ValueError("ell_matvec: padded CSR must be int32 ids, float32 values")
    _lib.require_cuda("ell_matvec", X.indices, X.values, X.nnz, w)
    out = torch.empty(n, dtype=torch.float32, device=w.device)
    code = _lib.library().port_ell_matvec(
        _lib.ptr(X.indices), _lib.ptr(X.values), _lib.ptr(X.nnz), X.indices.shape[1],
        _lib.ptr(w), _lib.ptr(out), n, lanes, blocks, _lib.stream())
    _lib.check(code, "ell_matvec")
    ell_matvec.launches += 1
    return out


ell_matvec.launches = 0


def ell_rmatvec(X: PaddedCSR, q: torch.Tensor, pcsc=None) -> torch.Tensor:
    """Xᵀ·q; ``pcsc`` (a PaddedCSC or TieredCSC of the same X) is required on CUDA."""
    d = X.shape[1]
    if q.device.type == "cpu":
        return ell_rmatvec_ref(X.indices, X.values, q, segments(X))
    if pcsc is None:
        raise ValueError("ell_rmatvec on CUDA gathers over the padded CSC; pass pcsc")
    if q.dtype != torch.float32 or q.shape != (X.shape[0],):
        raise ValueError(f"ell_rmatvec: q must be float32 of shape ({X.shape[0]},)")
    _lib.require_cuda("ell_rmatvec", q)
    cols = _lib.col_table(pcsc)
    segs = segments(X)
    _lib.require_cuda("ell_rmatvec: the padded CSR's segment table", segs.tasks,
                      segs.long_cols, segs.first)
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    partials = torch.empty(segs.tasks.shape[0], dtype=torch.float32, device=q.device)
    code = _lib.library().port_ell_rmatvec(
        *cols, _lib.ptr(q), _lib.ptr(out), d, SEGMENT, _lib.ptr(segs.tasks),
        segs.tasks.shape[0], _lib.ptr(segs.long_cols), _lib.ptr(segs.first),
        segs.long_cols.shape[0], _lib.ptr(partials), _lib.stream())
    _lib.check(code, "ell_rmatvec")
    ell_rmatvec.launches += 1
    return out


ell_rmatvec.launches = 0
