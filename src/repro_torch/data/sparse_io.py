"""Streaming libsvm/svmlight text I/O, bounded memory (copy of ``repro.data.sparse_io``).

The paper's datasets (RCV1, news20, URL, KDD2012 — Table 2) ship as
libsvm/svmlight text: one row per line, ``label idx:val idx:val ...``.  At
those scales (up to 8.4M rows × 20.2M features) the full COO triple never
fits comfortably in RAM, so the parser here is a *chunk iterator*: it reads
``chunk_rows`` lines at a time and yields self-contained :class:`LibsvmChunk`
objects (local CSR layout), which ``repro_torch.data.store.DatasetStore.write``
consumes to build the sharded on-disk store without ever materializing the
whole matrix.

Conventions (matching the LIBSVM distribution of the paper's datasets):

* indices are 1-based in the text unless ``zero_based=True``;
* labels parse to y ∈ {0, 1}: any label > 0 → 1.0, else 0.0 (covers the
  ``+1/-1`` and ``0/1`` conventions);
* ``# comment`` suffixes and ``qid:`` tokens are ignored;
* the writer emits values with ``%.17g`` so a float64 round-trips
  bit-for-bit through text — the store round-trip tests rely on this.
"""
from __future__ import annotations

import dataclasses
import io
from typing import IO, Iterable, Iterator, Union

import numpy as np

from repro_torch.core.sparse.formats import HostCSR

PathOrFile = Union[str, "io.TextIOBase", IO[str]]


@dataclasses.dataclass
class LibsvmChunk:
    """A contiguous block of rows in local CSR layout.

    ``indptr`` is chunk-local (``indptr[0] == 0``); ``cols`` are global
    0-based column ids; ``y`` is float64 in {0, 1}.
    """

    y: np.ndarray        # (rows,)  float64
    indptr: np.ndarray   # (rows+1,) int64, local
    cols: np.ndarray     # (nnz,)   int64
    vals: np.ndarray     # (nnz,)   float64

    @property
    def n_rows(self) -> int:
        return int(self.y.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    @property
    def max_col(self) -> int:
        return int(self.cols.max()) if self.nnz else -1


def _parse_line(line: str, zero_based: bool):
    """One libsvm line -> (label, [cols], [vals]); None for blank/comment."""
    hash_pos = line.find("#")
    if hash_pos >= 0:
        line = line[:hash_pos]
    parts = line.split()
    if not parts:
        return None
    label = float(parts[0])
    cols, vals = [], []
    off = 0 if zero_based else 1
    for tok in parts[1:]:
        if tok.startswith("qid:"):
            continue
        idx_s, _, val_s = tok.partition(":")
        j = int(idx_s) - off
        if j < 0:
            raise ValueError(f"column index {idx_s} underflows "
                             f"(zero_based={zero_based})")
        cols.append(j)
        vals.append(float(val_s))
    return (1.0 if label > 0 else 0.0), cols, vals


def iter_libsvm(source: PathOrFile, chunk_rows: int = 8192,
                zero_based: bool = False) -> Iterator[LibsvmChunk]:
    """Stream a libsvm text file as :class:`LibsvmChunk` blocks.

    Memory is bounded by ``chunk_rows`` rows (plus their nonzeros) — the full
    COO is never materialized, which is what lets ingestion scale to files
    larger than RAM.
    """
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be >= 1")
    own = isinstance(source, str)
    fh = open(source, "r") if own else source
    try:
        ys, lens, cols, vals = [], [], [], []
        for line in fh:
            parsed = _parse_line(line, zero_based)
            if parsed is None:
                continue
            label, c, v = parsed
            ys.append(label)
            lens.append(len(c))
            cols.extend(c)
            vals.extend(v)
            if len(ys) >= chunk_rows:
                yield _make_chunk(ys, lens, cols, vals)
                ys, lens, cols, vals = [], [], [], []
        if ys:
            yield _make_chunk(ys, lens, cols, vals)
    finally:
        if own:
            fh.close()


def _make_chunk(ys, lens, cols, vals) -> LibsvmChunk:
    indptr = np.zeros(len(ys) + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    return LibsvmChunk(
        y=np.asarray(ys, dtype=np.float64),
        indptr=indptr,
        cols=np.asarray(cols, dtype=np.int64),
        vals=np.asarray(vals, dtype=np.float64))


def chunks_from_arrays(X: HostCSR, y: np.ndarray,
                       chunk_rows: int = 8192) -> Iterator[LibsvmChunk]:
    """Adapt an in-memory (HostCSR, y) pair to the streaming chunk protocol."""
    y = np.asarray(y, dtype=np.float64)
    if y.shape[0] != X.shape[0]:
        raise ValueError("X/y row mismatch")
    for lo in range(0, X.shape[0], chunk_rows):
        hi = min(lo + chunk_rows, X.shape[0])
        p0, p1 = int(X.indptr[lo]), int(X.indptr[hi])
        yield LibsvmChunk(
            y=y[lo:hi].copy(),
            indptr=(X.indptr[lo:hi + 1] - X.indptr[lo]).astype(np.int64),
            cols=X.indices[p0:p1].astype(np.int64),
            vals=X.data[p0:p1].astype(np.float64))


def write_libsvm(dest: PathOrFile, X: HostCSR, y: np.ndarray,
                 zero_based: bool = False) -> None:
    """Write (X, y) as libsvm text; values use %.17g (float64-exact)."""
    y = np.asarray(y)
    own = isinstance(dest, str)
    fh = open(dest, "w") if own else dest
    off = 0 if zero_based else 1
    try:
        for i in range(X.shape[0]):
            idx, val = X.row(i)
            feats = " ".join(f"{int(j) + off}:{v:.17g}"
                             for j, v in zip(idx, val))
            fh.write(f"{y[i]:g} {feats}\n" if feats else f"{y[i]:g}\n")
    finally:
        if own:
            fh.close()


def iter_any(chunks_or_csr, y=None, chunk_rows: int = 8192
             ) -> Iterable[LibsvmChunk]:
    """Normalize store ingestion input: chunk iterable | (HostCSR, y)."""
    if isinstance(chunks_or_csr, HostCSR):
        if y is None:
            raise ValueError("labels required when ingesting a HostCSR")
        return chunks_from_arrays(chunks_or_csr, y, chunk_rows)
    return chunks_or_csr
