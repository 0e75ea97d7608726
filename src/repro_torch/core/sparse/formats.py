"""Sparse matrix containers of the port (counterpart of ``repro.core.sparse.formats``).

Two families, as in the JAX package:

* ``HostCSR`` / ``HostCSC`` — exact variable-length compressed formats in
  numpy, used to build the padded layouts.

* ``PaddedCSR`` / ``PaddedCSC`` / ``TieredCSC`` — fixed-shape ELL-style
  padded layouts held as torch tensors on one device.  Each row (column) is
  padded to the max nnz; padding entries carry ``index = 0`` and
  ``value = 0`` and ``nnz`` keeps the true per-row (per-column) count.  The
  CUDA kernels walk only the live lanes ``k < nnz``; the padding convention
  is kept so that the arrays equal the JAX package's element for element.

The padded builders scatter on the target device, so a full-size layout
(tens of GB of padded lanes) never passes through host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Shape = Tuple[int, int]


# ---------------------------------------------------------------------------
# Host (numpy, exact) formats
# ---------------------------------------------------------------------------


class HostCSR:
    """Compressed sparse row; numpy; exact (no padding)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, shape: Shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.float64)
        self.shape = (int(shape[0]), int(shape[1]))
        if self.indptr.shape != (self.shape[0] + 1,):
            raise ValueError("bad indptr length")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def row_ids(self) -> np.ndarray:
        """Row id of every stored entry (COO rows)."""
        return np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))

    def matvec(self, w: np.ndarray) -> np.ndarray:
        # one dot per row, as the JAX package sums it: the synthetic
        # generator draws labels from these margins
        out = np.zeros(self.shape[0])
        for i in range(self.shape[0]):
            idx, val = self.row(i)
            out[i] = val @ w[idx]
        return out

    def rmatvec(self, q: np.ndarray) -> np.ndarray:
        # row by row, as the JAX package sums it (the host engine's setup)
        out = np.zeros(self.shape[1])
        for i in range(self.shape[0]):
            idx, val = self.row(i)
            out[idx] += val * q[i]
        return out

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        out[self.row_ids(), self.indices] = self.data
        return out

    def tocsc(self) -> "HostCSC":
        """Column-major copy; rows stay ascending inside each column."""
        order = np.argsort(self.indices, kind="stable")
        counts = np.bincount(self.indices, minlength=self.shape[1])
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return HostCSC(indptr, self.row_ids()[order], self.data[order], self.shape)


class HostCSC:
    """Compressed sparse column; numpy; exact."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, shape: Shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.float64)
        self.shape = (int(shape[0]), int(shape[1]))
        if self.indptr.shape != (self.shape[1] + 1,):
            raise ValueError("bad indptr length")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def col(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[j], self.indptr[j + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        cols = np.repeat(np.arange(self.shape[1]), np.diff(self.indptr))
        out[self.indices, cols] = self.data
        return out


def coo_to_host(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Shape) -> HostCSR:
    """Build a HostCSR from COO triplets (duplicates are summed)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        first = np.ones(rows.size, dtype=bool)
        first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        if not first.all():
            # accumulate each run of duplicates in order into its first entry
            run = np.cumsum(first) - 1
            acc = np.zeros(int(first.sum()))
            for k in range(vals.size):
                acc[run[k]] += vals[k]
            rows, cols, vals = rows[first], cols[first], acc
    counts = np.bincount(rows, minlength=shape[0])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return HostCSR(indptr, cols, vals, shape)


def dense_to_host(x: np.ndarray) -> HostCSR:
    rows, cols = np.nonzero(x)
    return coo_to_host(rows, cols, x[rows, cols], x.shape)


# ---------------------------------------------------------------------------
# Padded (torch, fixed-shape) formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PaddedCSR:
    """ELL-style padded CSR: ``indices/values`` are (N, K) with K = max row nnz.

    Padding: ``index = 0, value = 0``; ``nnz`` keeps true per-row counts.
    """

    indices: torch.Tensor  # (N, K) int32 column ids
    values: torch.Tensor   # (N, K) float32
    nnz: torch.Tensor      # (N,)  int32
    shape: Shape           # (N, D)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "PaddedCSR":
        return PaddedCSR(self.indices.to(device), self.values.to(device),
                         self.nnz.to(device), self.shape)

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """X · w over the padded lanes (the plain version of ``ell_matvec``)."""
        from repro_torch.kernels.spmv.ref import ell_matvec_ref
        return ell_matvec_ref(self.indices, self.values, w)

    def rmatvec(self, q: torch.Tensor) -> torch.Tensor:
        """Xᵀ · q, summed in the segmented row order (the plain version of
        ``ell_rmatvec``)."""
        from repro_torch.kernels.spmv.ref import ell_rmatvec_ref, segments
        return ell_rmatvec_ref(self.indices, self.values, q, segments(self))


@dataclasses.dataclass
class PaddedCSC:
    """Padded CSC: per-column row ids.  Column j's rows = ``indices[j]``."""

    indices: torch.Tensor  # (D, K) int32 row ids
    values: torch.Tensor   # (D, K) float32
    nnz: torch.Tensor      # (D,)  int32
    shape: Shape           # (N, D)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def full_width(self) -> int:
        return int(self.indices.shape[1])

    def to(self, device) -> "PaddedCSC":
        return PaddedCSC(self.indices.to(device), self.values.to(device),
                         self.nnz.to(device), self.shape)

    def col_live(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rows/values of column j's live lanes only."""
        k = int(self.nnz[j])
        return self.indices[j, :k], self.values[j, :k]


@dataclasses.dataclass
class TieredCSC:
    """Two-tier padded CSC (the autotuner's exact-arithmetic ELL split).

    A narrow ``(D, k)`` primary table for the common case and a full-width
    ``(H, K)`` heavy table holding the columns whose nnz exceeds ``k``
    verbatim; a column is read from the heavy table when ``nnz[j] > k``.  No
    entry is dropped and padding stays ``index = 0, value = 0``.
    """

    indices: torch.Tensor        # (D, k) light-tier row ids (heavy cols truncated)
    values: torch.Tensor         # (D, k)
    nnz: torch.Tensor            # (D,) TRUE per-column counts (never clamped)
    heavy_slot: torch.Tensor     # (D,) int32 row in the heavy table (0 if light)
    heavy_indices: torch.Tensor  # (H, K) full-width rows of the heavy columns
    heavy_values: torch.Tensor   # (H, K)
    shape: Shape                 # (N, D)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def width(self) -> int:
        """Light-tier pad width k."""
        return int(self.indices.shape[1])

    @property
    def full_width(self) -> int:
        """Heavy-tier pad width = the flat layout's exact max column nnz."""
        return int(self.heavy_indices.shape[1])

    def to(self, device) -> "TieredCSC":
        return TieredCSC(*(t.to(device) for t in (
            self.indices, self.values, self.nnz, self.heavy_slot,
            self.heavy_indices, self.heavy_values)), shape=self.shape)

    def is_heavy(self, j: int) -> bool:
        return int(self.nnz[j]) > self.width

    def col_live(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rows/values of column j's live lanes, from whichever tier holds it."""
        k = int(self.nnz[j])
        if k > self.width:
            slot = int(self.heavy_slot[j])
            return self.heavy_indices[slot, :k], self.heavy_values[slot, :k]
        return self.indices[j, :k], self.values[j, :k]


def tiered_from_padded(pcsc: PaddedCSC, width: int) -> TieredCSC:
    """Split a flat ``PaddedCSC`` into the two-tier layout at ``width``.

    Columns with nnz <= width move to the narrow table unchanged (their
    truncated lanes were all padding); wider columns keep their full lanes in
    the heavy table.  Built on ``pcsc``'s device.
    """
    full = pcsc.full_width
    width = int(width)
    if not 1 <= width < full:
        raise ValueError(f"tier width must be in [1, {full}), got {width}")
    dev = pcsc.device
    heavy_cols = torch.nonzero(pcsc.nnz > width).flatten()
    h = max(1, int(heavy_cols.numel()))    # keep the table non-empty
    heavy_idx = torch.zeros((h, full), dtype=pcsc.indices.dtype, device=dev)
    heavy_val = torch.zeros((h, full), dtype=pcsc.values.dtype, device=dev)
    heavy_slot = torch.zeros(pcsc.indices.shape[0], dtype=torch.int32, device=dev)
    if heavy_cols.numel():
        heavy_idx[: heavy_cols.numel()] = pcsc.indices[heavy_cols]
        heavy_val[: heavy_cols.numel()] = pcsc.values[heavy_cols]
        heavy_slot[heavy_cols] = torch.arange(heavy_cols.numel(), dtype=torch.int32,
                                              device=dev)
    return TieredCSC(
        indices=pcsc.indices[:, :width].contiguous(),
        values=pcsc.values[:, :width].contiguous(),
        nnz=pcsc.nnz.clone(), heavy_slot=heavy_slot, heavy_indices=heavy_idx,
        heavy_values=heavy_val, shape=pcsc.shape)


def _pad_rows(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n_major: int,
              k: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_major, k) int32 ids / float32 values / true counts, scattered on ``device``."""
    counts = np.diff(indptr)
    major = np.repeat(np.arange(n_major), counts)
    lane = np.arange(indices.shape[0]) - np.repeat(indptr[:-1], counts)
    out_idx = torch.zeros((n_major, k), dtype=torch.int32, device=device)
    out_val = torch.zeros((n_major, k), dtype=torch.float32, device=device)
    at = (torch.from_numpy(major).to(device), torch.from_numpy(lane).to(device))
    out_idx[at] = torch.from_numpy(indices.astype(np.int32)).to(device)
    out_val[at] = torch.from_numpy(data.astype(np.float32)).to(device)
    nnz = torch.from_numpy(counts.astype(np.int32)).to(device)
    return out_idx, out_val, nnz


def host_to_padded(csr: HostCSR, device="cuda") -> Tuple[PaddedCSR, PaddedCSC]:
    """Both padded layouts of ``csr``, built on ``device``."""
    n, d = csr.shape
    csc = csr.tocsc()
    k_row = int(max(1, np.max(np.diff(csr.indptr)) if csr.nnz else 1))
    k_col = int(max(1, np.max(np.diff(csc.indptr)) if csc.nnz else 1))
    ri, rv, rn = _pad_rows(csr.indptr, csr.indices, csr.data, n, k_row, device)
    ci, cv, cn = _pad_rows(csc.indptr, csc.indices, csc.data, d, k_col, device)
    return PaddedCSR(ri, rv, rn, (n, d)), PaddedCSC(ci, cv, cn, (n, d))


def dense_to_padded(x: np.ndarray, device="cuda") -> Tuple[PaddedCSR, PaddedCSC]:
    """Convert a dense numpy matrix into both padded layouts."""
    return host_to_padded(dense_to_host(np.asarray(x)), device)
