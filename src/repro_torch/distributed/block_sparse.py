"""2-D block-sharded padded sparse design matrix (``repro.distributed.block_sparse``).

The sharded Frank-Wolfe engine splits the design matrix over an (a × b)
grid of ranks: **rows over a, features over b**.  Rank (ai, bj) holds the
(N/a × D/b) block X[rows_ai, cols_bj] in both padded layouts:

  * block CSC, for the selected column's local rows (the v̄/q̄ updates);
  * block CSR, for the touched rows' local columns (the α-shard updates).

Row and column ids inside a block are local, so each rank indexes only its
own shards.  Padding is one (Kc, Kr) for every block, as in the JAX
package, whose XLA programs need one shape.

Construction is the JAX package's two-pass COO bucketing, in numpy
(``BlockAssembler``): pass 1 counts lanes per block column and row (fixing
Kc and Kr), pass 2 writes values into the padded arrays with running fill
pointers.  The lane order inside a block column (row) is the global row
(stored column) order, whether the COO arrives whole or a store shard at a
time, so a layout either package builds is the same array, and a blocks
cache either package wrote loads in the other.  The finished arrays are
torch tensors on the host; each rank moves its own block to its device
(``BlockSparse.local``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.sparse.formats import HostCSR


class LocalBlock(NamedTuple):
    """One rank's block on its device."""

    csc_rows: torch.Tensor   # (D_loc, Kc) int32 local row ids
    csc_vals: torch.Tensor   # (D_loc, Kc) float32
    csr_cols: torch.Tensor   # (N_loc, Kr) int32 local column ids
    csr_vals: torch.Tensor   # (N_loc, Kr) float32


@dataclasses.dataclass
class BlockSparse:
    """All tensors lead with (A, B) = (row shards, feature shards)."""

    csc_rows: torch.Tensor   # (A, B, D_loc, Kc) int32 local row ids
    csc_vals: torch.Tensor   # (A, B, D_loc, Kc) float32
    csr_cols: torch.Tensor   # (A, B, N_loc, Kr) int32 local column ids
    csr_vals: torch.Tensor   # (A, B, N_loc, Kr) float32
    shape: Tuple[int, int]   # global (N, D)
    padded: Tuple[int, int]  # (N_pad, D_pad)

    @property
    def grid(self) -> Tuple[int, int]:
        return int(self.csc_rows.shape[0]), int(self.csc_rows.shape[1])

    @property
    def waste(self) -> float:
        true = float((self.csc_vals != 0).sum())
        return float(self.csc_vals.numel()) / max(true, 1.0)

    def local(self, ai: int, bj: int, device) -> LocalBlock:
        """Block (ai, bj) on ``device``."""
        return LocalBlock(*(t[ai, bj].to(device) for t in
                            (self.csc_rows, self.csc_vals, self.csr_cols, self.csr_vals)))


def block_layout(n: int, d: int, a: int, b: int) -> Tuple[int, int]:
    """Per-rank block shape (N_loc, D_loc) of an (a × b) grid."""
    return -(-n // a), -(-d // b)


def _run_ranks(sorted_key: np.ndarray) -> np.ndarray:
    """Rank of each element within its equal-key run (key already sorted)."""
    m = sorted_key.size
    if m == 0:
        return np.zeros(0, np.int64)
    run_start = np.zeros(m, np.int64)
    new_run = np.flatnonzero(sorted_key[1:] != sorted_key[:-1]) + 1
    run_start[new_run] = new_run
    return np.arange(m, dtype=np.int64) - np.maximum.accumulate(run_start)


class BlockAssembler:
    """Streaming COO → (a × b) padded block grid, in two vectorized passes.

    Feed COO fragments in global row order (``count`` them all, ``alloc``,
    then ``fill`` the same fragments in the same order).  Lane order inside
    each block column (row) is the global row (stored column) order: the
    running fill pointers carry it across fragments, so shard-at-a-time
    assembly equals whole-matrix assembly.
    """

    def __init__(self, n: int, d: int, a: int, b: int):
        self.n, self.d, self.a, self.b = n, d, a, b
        self.n_loc, self.d_loc = block_layout(n, d, a, b)
        self._col_counts = np.zeros(a * b * self.d_loc, np.int64)
        self._row_counts = np.zeros(a * b * self.n_loc, np.int64)
        self._arrays = None

    def _keys(self, rows: np.ndarray, cols: np.ndarray):
        ai, il = np.divmod(np.asarray(rows, np.int64), self.n_loc)
        bj, jl = np.divmod(np.asarray(cols, np.int64), self.d_loc)
        block = ai * self.b + bj
        return block * self.d_loc + jl, block * self.n_loc + il, il, jl

    def count(self, rows: np.ndarray, cols: np.ndarray) -> None:
        col_key, row_key, _, _ = self._keys(rows, cols)
        self._col_counts += np.bincount(col_key, minlength=self._col_counts.size)
        self._row_counts += np.bincount(row_key, minlength=self._row_counts.size)

    def alloc(self, kc: int = 1, kr: int = 1) -> None:
        """Fix (Kc, Kr) from the counts, at least (``kc``, ``kr``), and
        allocate the padded arrays."""
        a, b = self.a, self.b
        self.kc = max(kc, int(self._col_counts.max(initial=0)))
        self.kr = max(kr, int(self._row_counts.max(initial=0)))
        self._arrays = (
            np.zeros((a, b, self.d_loc, self.kc), np.int32),
            np.zeros((a, b, self.d_loc, self.kc), np.float32),
            np.zeros((a, b, self.n_loc, self.kr), np.int32),
            np.zeros((a, b, self.n_loc, self.kr), np.float32),
        )
        self._col_fill = np.zeros_like(self._col_counts)
        self._row_fill = np.zeros_like(self._row_counts)

    def fill(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> None:
        if self._arrays is None:
            raise RuntimeError("call alloc() after the counting pass")
        col_key, row_key, il, jl = self._keys(rows, cols)
        vals = np.asarray(vals, np.float64)
        for key, fill, lane_k, dest_i, dest_v, local in (
            (col_key, self._col_fill, self.kc, self._arrays[0], self._arrays[1], il),
            (row_key, self._row_fill, self.kr, self._arrays[2], self._arrays[3], jl),
        ):
            order = np.argsort(key, kind="stable")   # keep arrival order
            k_sorted = key[order]
            lane = fill[k_sorted] + _run_ranks(k_sorted)
            flat = k_sorted * lane_k + lane
            dest_i.reshape(-1)[flat] = local[order]
            dest_v.reshape(-1)[flat] = vals[order]
            fill += np.bincount(key, minlength=fill.size)

    def finish(self) -> BlockSparse:
        return BlockSparse(*(torch.from_numpy(arr) for arr in self._arrays),
                           shape=(self.n, self.d),
                           padded=(self.n_loc * self.a, self.d_loc * self.b))


def build_block_sparse(X: HostCSR, a: int, b: int) -> BlockSparse:
    """Split a ``HostCSR`` into an (a × b) block grid of padded layouts."""
    n, d = X.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(X.indptr))
    asm = BlockAssembler(n, d, a, b)
    asm.count(rows, X.indices)
    asm.alloc()
    asm.fill(rows, X.indices, X.data)
    return asm.finish()


def block_specs(n: int, d: int, a: int, b: int, kc: int, kr: int
                ) -> Tuple[BlockSparse, LocalBlock]:
    """``meta`` stand-ins for dry runs (no allocation): the (a × b) grid's
    ``BlockSparse`` at padding (Kc, Kr), and one rank's ``LocalBlock``."""
    n_loc, d_loc = block_layout(n, d, a, b)
    meta = lambda *shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    grid = BlockSparse(csc_rows=meta(a, b, d_loc, kc, dtype=torch.int32),
                       csc_vals=meta(a, b, d_loc, kc, dtype=torch.float32),
                       csr_cols=meta(a, b, n_loc, kr, dtype=torch.int32),
                       csr_vals=meta(a, b, n_loc, kr, dtype=torch.float32),
                       shape=(n, d), padded=(n_loc * a, d_loc * b))
    return grid, LocalBlock(*(t[0, 0] for t in (grid.csc_rows, grid.csc_vals,
                                                grid.csr_cols, grid.csr_vals)))
