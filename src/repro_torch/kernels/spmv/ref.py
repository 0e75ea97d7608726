"""Plain PyTorch versions of the ``ell_matvec`` and ``ell_rmatvec`` kernels.

Semantics (as ``repro/kernels/spmv/ref.py``): ``indices``/``values`` are the
(N, K) padded CSR, each row padded with ``index = 0, value = 0``;
``matvec``: ``out[i] = Σ_k values[i,k]·w[indices[i,k]]`` → (N,);
``rmatvec``: ``out[j] = Σ_{i,k: indices[i,k]=j} values[i,k]·q[i]`` → (D,).

The order of ``rmatvec``'s float32 sums is part of its contract, shared with
the CUDA kernel: cut each column's live entries, in ascending row order, into
segments of ``SEGMENT`` consecutive entries; a segment's partial is
``((0 + a₀) + a₁) + …`` in row order, and the column's result is
``((0 + p₀) + p₁) + …`` over its segments in order.  A column of at most
``SEGMENT`` entries is the plain row-order sum.  On the CPU, ``index_add_``
adds in index order, so two passes give that order: the products into the
(column, segment) slots, then the slots into the columns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SEGMENT = 256   # L: entries of a column summed in one in-order chain


def ell_matvec_ref(indices: torch.Tensor, values: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    return (values * w[indices.long()]).sum(dim=1)


class Segments(NamedTuple):
    """``rmatvec``'s summation order for one padded CSR, on its device: where
    each live entry goes (the plain version) and the work list of the columns
    longer than one segment (the CUDA kernel).  Both come from the per-column
    counts; ``segments`` builds them once per matrix."""

    lanes: torch.Tensor      # (E,) int64 flat lanes of the live entries, row-major
    slot: torch.Tensor       # (E,) int64 (column, segment) slot of each entry
    slot_col: torch.Tensor   # (S,) int64 column of each slot, slots in (column, segment) order
    tasks: torch.Tensor      # (W, 2) int32 (column, segment) slots of the long columns
    long_cols: torch.Tensor  # (C,) int32 the columns of more than ``SEGMENT`` entries, ascending
    first: torch.Tensor      # (C + 1,) int32 each long column's first task
    d: int


def build_segments(indices: torch.Tensor, nnz: torch.Tensor, d: int,
                   seg: int = SEGMENT) -> Segments:
    """The segment slots of a padded CSR's live entries (ranks by a stable sort)."""
    dev = indices.device
    k = indices.shape[1]
    live = torch.arange(k, device=dev)[None, :] < nnz.to(dev)[:, None]
    lanes = torch.nonzero(live.reshape(-1)).flatten()
    cols = indices.reshape(-1)[lanes].long()
    order = torch.sort(cols, stable=True).indices      # by column, rows ascending
    counts = torch.bincount(cols, minlength=d)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(cols)
    rank[order] = torch.arange(cols.numel(), device=dev) - first[cols[order]]
    nseg = (counts + seg - 1) // seg
    slot_first = torch.cumsum(nseg, 0) - nseg
    slot = slot_first[cols] + rank // seg
    slot_col = torch.repeat_interleave(torch.arange(d, device=dev), nseg)
    long = counts[slot_col] > seg
    tasks = torch.stack([slot_col[long], (torch.arange(slot_col.numel(), device=dev)
                                          - slot_first[slot_col])[long]], 1)
    long_cols = torch.nonzero(counts > seg).flatten()
    task_first = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                            torch.cumsum(nseg[long_cols], 0)])
    i32 = lambda t: t.to(torch.int32).contiguous()
    return Segments(lanes, slot, slot_col, i32(tasks), i32(long_cols), i32(task_first), d)


def segments(X) -> Segments:
    """``X``'s (a ``PaddedCSR``) segment order, built on first use and kept on ``X``."""
    segs = X.__dict__.get("_segments")
    if segs is None:
        segs = X._segments = build_segments(X.indices, X.nnz, X.shape[1])
    return segs


def ell_rmatvec_ref(indices: torch.Tensor, values: torch.Tensor, q: torch.Tensor,
                    segs: Segments) -> torch.Tensor:
    contrib = (values * q[:, None]).reshape(-1)[segs.lanes]
    part = torch.zeros(segs.slot_col.numel(), dtype=values.dtype, device=values.device)
    part.index_add_(0, segs.slot, contrib)
    out = torch.zeros(segs.d, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segs.slot_col, part)
