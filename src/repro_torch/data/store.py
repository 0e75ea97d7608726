"""Sharded on-disk sparse dataset store with mmap views and cached setup
(port of ``repro.data.store``; the same files, read and written by both
packages).

The paper's pipeline starts from huge static sparse datasets (Table 2: up to
8.4M rows × 20.2M features) that every (λ, ε) grid point and every tenant
re-reads.  ``DatasetStore`` materializes a dataset **once**:

    <root>/
      manifest.json                   shapes, dtypes, per-shard nnz, hash
      shard-00000.indptr.npy          int64 (rows+1,), shard-local
      shard-00000.indices.npy         int64 (nnz,), global column ids
      shard-00000.data.npy            float64 (nnz,)
      shard-00000.y.npy               float64 (rows,)
      colstats.npz                    df / norm_sq / col_sum / col_y_sum
      cache/padded-{csr,csc}.*.npy    ELL padded device layout (mmap-read)
      cache/setup-<loss>-torch-<device>.npz   the port's fw_setup state
      cache/setup-<loss>-<mode>.npz   the JAX package's (never read here)

* **Ingestion is streaming**: ``DatasetStore.write`` consumes the chunk
  protocol of ``repro_torch.data.sparse_io`` (libsvm parser or in-memory
  adapter), holding at most one shard in RAM, and accumulates the O(NS)
  per-column statistics in the same single pass.  The content hash is the
  JAX package's byte for byte, so each package sees the other's caches as
  current.
* **Reads are zero-copy**: ``shard(i)`` returns a ``HostCSR`` over
  ``np.load(..., mmap_mode="r")`` views in the dtypes ``HostCSR`` keeps
  (int64/float64); the padded builders round to float32 on the device.
* **Splits are deterministic**: ``split`` hashes global row ids (splitmix64)
  so train/test membership is a pure function of (row, salt).
* **Setup is cached**: ``prepared(device)`` returns a
  ``repro_torch.core.solvers.prepared.PreparedDataset`` on ``device``.  The
  padded ELL lanes are the JAX package's arrays element for element, so both
  packages share ``cache/padded-*``: a warm open copies them from the
  mapping onto the device in row blocks (never writing into the mapping).
  The fw_setup state is the port's own file, keyed by device: the port's
  segmented ``ell_rmatvec`` and JAX's ``fw_setup`` add in different orders,
  and replaying the other's state would break ``solve(store)`` ≡
  ``solve(X)`` bit for bit.  ``setup_streamed`` rebuilds the state in O(D)
  from the ingest-time column stats.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparse.formats import HostCSR
from repro_torch.data.sparse_io import LibsvmChunk, iter_any


def _cache_count(cache: str, hit: bool) -> None:
    obs.count("store.cache", cache=cache, outcome="hit" if hit else "miss")


FORMAT_VERSION = 1
MANIFEST = "manifest.json"
COLSTATS = "colstats.npz"
CACHE_DIR = "cache"
# bytes per host ↔ device copy when a cached padded table is loaded or saved
COPY_BLOCK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column O(NS) ingest-pass products (the solvers' setup currency).

    ``col_y_sum`` is ``Xᵀy`` unnormalized; with ``col_sum`` it rebuilds the
    Frank-Wolfe setup state in O(D): ȳ = col_y_sum/N and, since v̄₀ = 0 makes
    q̄₀ = h(0)·1 constant for every supported loss,
    α₀ = h(0)·col_sum/N − ȳ.  No data pass required.
    """

    df: np.ndarray         # (D,) int64   rows containing the column
    norm_sq: np.ndarray    # (D,) float64 Σ x_ij²
    col_sum: np.ndarray    # (D,) float64 Σ x_ij
    col_y_sum: np.ndarray  # (D,) float64 Σ x_ij·y_i

    @property
    def norm(self) -> np.ndarray:
        return np.sqrt(self.norm_sq)


def _hash01(idx: np.ndarray, salt: int) -> np.ndarray:
    """splitmix64 finalizer → uniform [0, 1) per global row id (+ salt)."""
    x = idx.astype(np.uint64)
    x = x + np.uint64((0x9E3779B97F4A7C15 * (salt + 1)) & 0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _grow_to(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[0] >= size:
        return arr
    out = np.zeros(max(size, 2 * arr.shape[0]), dtype=arr.dtype)
    out[:arr.shape[0]] = arr
    return out


class _ShardWriter:
    """Buffers chunks; flushes ≥ rows_per_shard rows as one on-disk shard."""

    def __init__(self, root: str, rows_per_shard: int):
        self.root = root
        self.rows_per_shard = rows_per_shard
        self.buf: List[LibsvmChunk] = []
        self.buf_rows = 0
        self.shards: List[dict] = []

    def add(self, chunk: LibsvmChunk) -> None:
        self.buf.append(chunk)
        self.buf_rows += chunk.n_rows
        while self.buf_rows >= self.rows_per_shard:
            self._flush(self.rows_per_shard)

    def finish(self) -> List[dict]:
        if self.buf_rows:
            self._flush(self.buf_rows)
        return self.shards

    def _flush(self, rows: int) -> None:
        take, rest, got = [], [], 0
        for c in self.buf:
            if got >= rows:
                rest.append(c)
            elif got + c.n_rows <= rows:
                take.append(c)
                got += c.n_rows
            else:  # split a chunk at the shard boundary
                cut = rows - got
                p = int(c.indptr[cut])
                take.append(LibsvmChunk(c.y[:cut], c.indptr[:cut + 1].copy(),
                                        c.cols[:p], c.vals[:p]))
                rest.append(LibsvmChunk(c.y[cut:], c.indptr[cut:] - p,
                                        c.cols[p:], c.vals[p:]))
                got = rows
        self.buf, self.buf_rows = rest, sum(c.n_rows for c in rest)

        indptr = np.zeros(rows + 1, dtype=np.int64)
        pos = 0
        for c in take:
            indptr[pos + 1: pos + c.n_rows + 1] = indptr[pos] + c.indptr[1:]
            pos += c.n_rows
        cols = np.concatenate([c.cols for c in take]) if take else \
            np.zeros(0, np.int64)
        vals = np.concatenate([c.vals for c in take]) if take else \
            np.zeros(0, np.float64)
        y = np.concatenate([c.y for c in take]) if take else \
            np.zeros(0, np.float64)

        i = len(self.shards)
        base = os.path.join(self.root, f"shard-{i:05d}")
        np.save(base + ".indptr.npy", indptr)
        np.save(base + ".indices.npy", cols.astype(np.int64))
        np.save(base + ".data.npy", vals.astype(np.float64))
        np.save(base + ".y.npy", y.astype(np.float64))
        self.shards.append({"rows": rows, "nnz": int(cols.shape[0])})


class DatasetStore:
    """Open/written handle over one sharded on-disk sparse dataset."""

    def __init__(self, root: str, manifest: dict):
        self.root = root
        self.manifest = manifest
        self._labels: Optional[np.ndarray] = None
        self._csr: Optional[HostCSR] = None
        self._stats: Optional[ColumnStats] = None
        self._prepared: Dict[str, object] = {}
        self._row_starts = np.concatenate(
            [[0], np.cumsum([s["rows"] for s in manifest["shards"]])]
        ).astype(np.int64)

    # ------------------------------------------------------------ properties
    @property
    def n(self) -> int:
        return int(self.manifest["n"])

    @property
    def d(self) -> int:
        return int(self.manifest["d"])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.d)

    @property
    def nnz(self) -> int:
        return int(self.manifest["nnz"])

    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    @property
    def content_hash(self) -> str:
        return self.manifest["content_hash"]

    # ------------------------------------------------------------- write/open
    @classmethod
    def write(cls, root: str, chunks: Iterable[LibsvmChunk], *,
              n_cols: Optional[int] = None, rows_per_shard: int = 65536,
              source: Optional[dict] = None) -> "DatasetStore":
        """Stream ``chunks`` (see ``sparse_io``) into a new store at ``root``.

        One pass, bounded memory: shards are flushed every ``rows_per_shard``
        rows; column stats and the content hash accumulate alongside.  ``d``
        is ``n_cols`` when given, else ``max column id + 1``.

        The write is atomic at the directory level: everything lands in a
        sibling temp dir that replaces ``root`` only once the manifest is
        complete, so an interrupted (re)build leaves either the previous
        store intact or no store at all — never a mixed one that
        ``open()`` would happily serve.
        """
        if rows_per_shard < 1:
            raise ValueError("rows_per_shard must be >= 1")
        root = os.path.normpath(root)
        tmp_root = f"{root}.tmp-{os.getpid()}"
        if os.path.exists(tmp_root):
            shutil.rmtree(tmp_root)
        os.makedirs(tmp_root)
        os.makedirs(os.path.join(tmp_root, CACHE_DIR))
        writer = _ShardWriter(tmp_root, rows_per_shard)
        row_nnz_max = 0
        # one hasher per logical stream so the digest is invariant to chunk
        # geometry: the same rows hash identically however they arrive
        h_lens, h_cols, h_vals, h_y = (hashlib.sha256() for _ in range(4))
        size0 = n_cols or 1024
        df = np.zeros(size0, np.int64)
        norm_sq = np.zeros(size0, np.float64)
        col_sum = np.zeros(size0, np.float64)
        col_y_sum = np.zeros(size0, np.float64)
        n = nnz = 0
        max_col = -1
        for chunk in chunks:
            if chunk.n_rows == 0:
                continue
            row_lens = np.diff(chunk.indptr).astype(np.int64)
            if row_lens.size:
                row_nnz_max = max(row_nnz_max, int(row_lens.max()))
            h_lens.update(row_lens.tobytes())
            h_cols.update(chunk.cols.astype(np.int64).tobytes())
            h_vals.update(chunk.vals.astype(np.float64).tobytes())
            h_y.update(chunk.y.astype(np.float64).tobytes())
            if chunk.nnz:
                max_col = max(max_col, chunk.max_col)
                df = _grow_to(df, max_col + 1)
                norm_sq = _grow_to(norm_sq, max_col + 1)
                col_sum = _grow_to(col_sum, max_col + 1)
                col_y_sum = _grow_to(col_y_sum, max_col + 1)
                # bincount, not np.add.at: this is the ingest hot loop and
                # the unbuffered ufunc scatter is ~10-50x slower per nnz
                df += np.bincount(chunk.cols, minlength=df.size)
                norm_sq += np.bincount(chunk.cols, weights=chunk.vals ** 2,
                                       minlength=norm_sq.size)
                col_sum += np.bincount(chunk.cols, weights=chunk.vals,
                                       minlength=col_sum.size)
                y_rep = np.repeat(chunk.y, np.diff(chunk.indptr))
                col_y_sum += np.bincount(chunk.cols,
                                         weights=chunk.vals * y_rep,
                                         minlength=col_y_sum.size)
            n += chunk.n_rows
            nnz += chunk.nnz
            writer.add(chunk)
        shards = writer.finish()
        d = n_cols if n_cols is not None else max_col + 1
        if max_col >= d:
            raise ValueError(f"column id {max_col} >= n_cols={d}")
        manifest = {
            "format_version": FORMAT_VERSION,
            "n": n, "d": d, "nnz": nnz,
            "index_dtype": "int64", "value_dtype": "float64",
            "rows_per_shard": rows_per_shard,
            "shards": shards,
            # max row/col nnz: the planner's O(1) ProblemStats source —
            # col max is exact off the df counts (one per stored entry)
            "row_nnz_max": row_nnz_max,
            "col_nnz_max": int(df[:d].max()) if d else 0,
            "content_hash": hashlib.sha256(
                b"".join(h.digest()
                         for h in (h_lens, h_cols, h_vals, h_y))).hexdigest(),
            "source": source or {},
            "created_unix": time.time(),
        }
        np.savez(os.path.join(tmp_root, COLSTATS),
                 df=df[:d].copy(), norm_sq=norm_sq[:d].copy(),
                 col_sum=col_sum[:d].copy(), col_y_sum=col_y_sum[:d].copy())
        with open(os.path.join(tmp_root, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        # commit: swap the finished temp dir into place
        if os.path.exists(root):
            shutil.rmtree(root)
        os.makedirs(os.path.dirname(root) or ".", exist_ok=True)
        os.rename(tmp_root, root)
        return cls(root, manifest)

    @classmethod
    def from_arrays(cls, root: str, X: HostCSR, y, *,
                    rows_per_shard: int = 65536, chunk_rows: int = 8192,
                    source: Optional[dict] = None) -> "DatasetStore":
        """Materialize an in-memory (HostCSR, y) pair through the store."""
        return cls.write(root, iter_any(X, y, chunk_rows), n_cols=X.shape[1],
                         rows_per_shard=rows_per_shard, source=source)

    @classmethod
    def open(cls, root: str) -> "DatasetStore":
        path = os.path.join(root, MANIFEST)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no dataset store at {root!r} "
                                    f"(missing {MANIFEST})")
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"store {root!r} has format_version "
                f"{manifest.get('format_version')}, expected {FORMAT_VERSION}")
        return cls(root, manifest)

    @staticmethod
    def exists(root: str) -> bool:
        return os.path.exists(os.path.join(root, MANIFEST))

    # ----------------------------------------------------------------- reads
    def _shard_base(self, i: int) -> str:
        if not 0 <= i < self.n_shards:
            raise IndexError(f"shard {i} out of range [0, {self.n_shards})")
        return os.path.join(self.root, f"shard-{i:05d}")

    def shard(self, i: int) -> HostCSR:
        """Zero-copy mmap ``HostCSR`` view of shard ``i`` (global col ids)."""
        base = self._shard_base(i)
        indptr = np.load(base + ".indptr.npy", mmap_mode="r")
        indices = np.load(base + ".indices.npy", mmap_mode="r")
        data = np.load(base + ".data.npy", mmap_mode="r")
        return HostCSR(indptr, indices, data,
                       (self.manifest["shards"][i]["rows"], self.d))

    def shard_labels(self, i: int) -> np.ndarray:
        return np.load(self._shard_base(i) + ".y.npy", mmap_mode="r")

    def shard_row_range(self, i: int) -> Tuple[int, int]:
        return int(self._row_starts[i]), int(self._row_starts[i + 1])

    def iter_shards(self):
        """(row_start, HostCSR view, labels view) per shard — the out-of-core
        access pattern: one shard resident at a time."""
        for i in range(self.n_shards):
            yield int(self._row_starts[i]), self.shard(i), self.shard_labels(i)

    def labels(self) -> np.ndarray:
        if self._labels is None:
            self._labels = (
                np.concatenate([self.shard_labels(i)
                                for i in range(self.n_shards)])
                if self.n_shards else np.zeros(0, np.float64))
        return self._labels

    def to_host_csr(self) -> HostCSR:
        """The whole dataset as one ``HostCSR``.

        Single-shard stores stay zero-copy (the mmap views pass straight
        through); multi-shard stores concatenate — use ``iter_shards`` when
        N×S does not fit in RAM.
        """
        if self._csr is None:
            if self.n_shards == 1:
                self._csr = self.shard(0)
            else:
                parts = [self.shard(i) for i in range(self.n_shards)]
                indptr = np.zeros(self.n + 1, np.int64)
                pos = 0
                for p in parts:
                    rows = p.shape[0]
                    indptr[pos + 1: pos + rows + 1] = \
                        indptr[pos] + p.indptr[1:]
                    pos += rows
                self._csr = HostCSR(
                    indptr,
                    np.concatenate([p.indices for p in parts])
                    if parts else np.zeros(0, np.int64),
                    np.concatenate([p.data for p in parts])
                    if parts else np.zeros(0, np.float64),
                    self.shape)
        return self._csr

    def col_stats(self) -> ColumnStats:
        if self._stats is None:
            with np.load(os.path.join(self.root, COLSTATS)) as z:
                self._stats = ColumnStats(df=z["df"], norm_sq=z["norm_sq"],
                                          col_sum=z["col_sum"],
                                          col_y_sum=z["col_y_sum"])
        return self._stats

    # ---------------------------------------------------------------- splits
    def split(self, test_frac: float = 0.2, salt: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic hash-based (train_rows, test_rows) global row ids."""
        if not 0.0 <= test_frac <= 1.0:
            raise ValueError("test_frac must be in [0, 1]")
        u = _hash01(np.arange(self.n, dtype=np.int64), salt)
        test = u < test_frac
        idx = np.arange(self.n, dtype=np.int64)
        return idx[~test], idx[test]

    def take(self, rows: Sequence[int]) -> Tuple[HostCSR, np.ndarray]:
        """Materialize a row subset as an exact in-memory (HostCSR, y).

        Output rows follow the order of ``rows`` (duplicates allowed), so a
        shuffled permutation yields a shuffled matrix.
        """
        rows = np.asarray(rows, dtype=np.int64)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        if rows.size and (sorted_rows[0] < 0 or sorted_rows[-1] >= self.n):
            raise IndexError("row id out of range")
        lens_parts, idx_parts, val_parts, y_parts = [], [], [], []
        for si in range(self.n_shards):
            lo, hi = self.shard_row_range(si)
            local = sorted_rows[(sorted_rows >= lo) & (sorted_rows < hi)] - lo
            if local.size == 0:
                continue
            csr = self.shard(si)
            starts = csr.indptr[local]
            lens = csr.indptr[local + 1] - starts
            total = int(lens.sum())
            take_idx = (np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens)[:-1]]), lens)
                + np.arange(total)) if total else np.zeros(0, np.int64)
            lens_parts.append(lens)
            idx_parts.append(np.asarray(csr.indices[take_idx]))
            val_parts.append(np.asarray(csr.data[take_idx]))
            y_parts.append(np.asarray(self.shard_labels(si))[local])
        lens_sorted = np.concatenate(lens_parts) if lens_parts else \
            np.zeros(0, np.int64)
        idx_sorted = np.concatenate(idx_parts) if idx_parts \
            else np.zeros(0, np.int64)
        val_sorted = np.concatenate(val_parts) if val_parts \
            else np.zeros(0, np.float64)
        y_sorted = np.concatenate(y_parts) if y_parts \
            else np.zeros(0, np.float64)
        # un-sort: output position i holds the row rows[i]
        inv = np.empty(rows.size, np.int64)
        inv[order] = np.arange(rows.size)
        indptr_sorted = np.zeros(rows.size + 1, np.int64)
        np.cumsum(lens_sorted, out=indptr_sorted[1:])
        starts = indptr_sorted[inv]
        lens = lens_sorted[inv]
        total = int(lens.sum())
        gather = (np.repeat(starts - np.concatenate(
            [[0], np.cumsum(lens)[:-1]]), lens)
            + np.arange(total)) if total else np.zeros(0, np.int64)
        indptr = np.zeros(rows.size + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        return (HostCSR(indptr, idx_sorted[gather], val_sorted[gather],
                        (rows.size, self.d)),
                y_sorted[inv])

    # ------------------------------------------------------- solver adapters
    def _padded_meta_path(self) -> str:
        return os.path.join(self.root, CACHE_DIR, "padded-meta.json")

    def _padded_load(self, device):
        """The padded ELL pair copied off mmap onto ``device``, or None on a
        cache miss (the files are shared with the JAX package)."""
        meta_path = self._padded_meta_path()
        if not os.path.exists(meta_path):
            _cache_count("padded", hit=False)
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("content_hash") != self.content_hash:
            _cache_count("padded", hit=False)
            return None
        _cache_count("padded", hit=True)
        from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR

        def arrays(kind):
            base = os.path.join(self.root, CACHE_DIR, f"padded-{kind}")
            return tuple(_load_npy(f"{base}.{part}.npy", device)
                         for part in ("indices", "values", "nnz"))

        return (PaddedCSR(*arrays("csr"), shape=self.shape),
                PaddedCSC(*arrays("csc"), shape=self.shape))

    def _padded_save(self, pcsr, pcsc) -> None:
        os.makedirs(os.path.join(self.root, CACHE_DIR), exist_ok=True)
        for kind, p in (("csr", pcsr), ("csc", pcsc)):
            base = os.path.join(self.root, CACHE_DIR, f"padded-{kind}")
            for part in ("indices", "values", "nnz"):
                _save_npy(f"{base}.{part}.npy", getattr(p, part))
        with open(self._padded_meta_path(), "w") as f:
            json.dump({"content_hash": self.content_hash}, f)

    def _blocks_meta_path(self, a: int, b: int) -> str:
        return os.path.join(self.root, CACHE_DIR, f"blocks-{a}x{b}-meta.json")

    def blocks_load(self, a: int, b: int):
        """The cached (a × b) ``BlockSparse`` of the sharded engine on the
        host, or None on a miss: the JAX package's ``cache/blocks-{a}x{b}.*``
        files, guarded by the content hash, so either package reads the
        other's."""
        meta_path = self._blocks_meta_path(a, b)
        if not os.path.exists(meta_path):
            _cache_count("blocks", hit=False)
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("content_hash") != self.content_hash:
            _cache_count("blocks", hit=False)
            return None
        _cache_count("blocks", hit=True)
        from repro_torch.distributed.block_sparse import BlockSparse
        base = os.path.join(self.root, CACHE_DIR, f"blocks-{a}x{b}")
        arrays = {part: _load_npy(f"{base}.{part}.npy", "cpu")
                  for part in ("csc_rows", "csc_vals", "csr_cols", "csr_vals")}
        return BlockSparse(shape=tuple(meta["shape"]), padded=tuple(meta["padded"]), **arrays)

    def blocks_save(self, a: int, b: int, blocks) -> None:
        os.makedirs(os.path.join(self.root, CACHE_DIR), exist_ok=True)
        base = os.path.join(self.root, CACHE_DIR, f"blocks-{a}x{b}")
        for part in ("csc_rows", "csc_vals", "csr_cols", "csr_vals"):
            _save_npy(f"{base}.{part}.npy", getattr(blocks, part))
        with open(self._blocks_meta_path(a, b), "w") as f:
            json.dump({"content_hash": self.content_hash, "shape": list(blocks.shape),
                       "padded": list(blocks.padded)}, f)

    def _autotune_path(self, backend: str, loss: str, platform: str) -> str:
        return os.path.join(self.root, CACHE_DIR,
                            f"autotune-{backend}-{loss}-{platform}.json")

    def autotune_load(self, backend: str, loss: str, platform: str):
        """The persisted ``TuningRecord`` for (backend, loss, platform), or
        None — guarded by the store's content hash and the record version.
        The port's platforms are ``torch-cuda``/``torch-cpu``
        (``autotune.platform_of``), never one of the JAX package's."""
        path = self._autotune_path(backend, loss, platform)
        if not os.path.exists(path):
            _cache_count("autotune", hit=False)
            return None
        from repro_torch.core.solvers.autotune import TuningRecord
        with open(path) as f:
            rec = TuningRecord.from_json(json.load(f))
        if rec is None or rec.content_hash != self.content_hash:
            _cache_count("autotune", hit=False)
            return None
        _cache_count("autotune", hit=True)
        return rec

    def autotune_save(self, record) -> None:
        os.makedirs(os.path.join(self.root, CACHE_DIR), exist_ok=True)
        path = self._autotune_path(record.backend, record.loss,
                                   record.platform)
        with open(path, "w") as f:
            json.dump(record.to_json(), f, indent=1)

    def _setup_cache_path(self, loss: str, device_type: str) -> str:
        return os.path.join(self.root, CACHE_DIR,
                            f"setup-{loss}-torch-{device_type}.npz")

    def _setup_load(self, loss: str, device):
        device = torch.device(device)
        path = self._setup_cache_path(loss, device.type)
        if not os.path.exists(path):
            _cache_count("setup", hit=False)
            return None
        with np.load(path) as z:
            if str(z["content_hash"]) != self.content_hash:
                _cache_count("setup", hit=False)
                return None
            _cache_count("setup", hit=True)
            return tuple(torch.from_numpy(z[k]).to(device)
                         for k in ("vbar0", "qbar0", "alpha0"))

    def _setup_save(self, loss: str, device, state) -> None:
        vbar0, qbar0, alpha0 = (s.cpu().numpy() for s in state)
        os.makedirs(os.path.join(self.root, CACHE_DIR), exist_ok=True)
        np.savez(self._setup_cache_path(loss, torch.device(device).type),
                 vbar0=vbar0, qbar0=qbar0, alpha0=alpha0,
                 content_hash=np.array(self.content_hash))

    def prepared(self, device="cuda"):
        """Device-ready ``PreparedDataset`` on ``device`` (padded pair +
        setup cache).

        Built once per open store and device, and memoized.  Both layers
        persist under ``cache/`` across processes: the padded ELL lanes are
        copied from the mapping on warm opens (skipping the padding pass),
        and the fw_setup state is replayed bit for bit (skipping the setup
        ``Xᵀq``) — every cache file is guarded by the store's content hash.
        A cold open pads on the device and copies the lanes back to write
        them.  ``device="cuda"`` without a card raises, as ``solve`` does.
        With telemetry on, the spans ``store.padded_load``, ``store.pad``
        and ``store.padded_save`` time the three steps.

        The returned dataset's hooks refer back to this store, so a dropped
        store frees its device tensors at the next garbage collection, not
        at once (``gc.collect()`` frees them).
        """
        from repro_torch.core.solvers.registry import check_device
        device = check_device(device)
        key = str(device)
        if key not in self._prepared:
            from repro_torch.core.solvers.prepared import PreparedDataset
            from repro_torch.core.sparse.formats import host_to_padded
            with obs.span("store.padded_load"):
                pair = self._padded_load(device)   # padded lanes off the mapping
            if pair is None:
                with obs.span("store.pad"):
                    pair = host_to_padded(self.to_host_csr(), device)
                with obs.span("store.padded_save"):
                    self._padded_save(*pair)
            pcsr, pcsc = pair
            self._prepared[key] = PreparedDataset(
                pcsr=pcsr, pcsc=pcsc,
                y=np.asarray(self.labels(), np.float64),
                loader=self._setup_load, saver=self._setup_save,
                tuning_loader=self.autotune_load)
        return self._prepared[key]

    def setup_streamed(self, loss: str = "logistic", device="cuda"):
        """Out-of-core fw_setup: (v̄₀, q̄₀, α₀) in O(D) from column stats.

        Because v̄₀ = 0 and labels are binary, the initial row gradient is an
        affine function of y: q̄₀_i = grad(0, y_i) = a + b·y_i with
        a = grad(0, 0) and b = grad(0, 1) − a (exact on y ∈ {0, 1}, the
        store's label contract — for separable losses this is the familiar
        constant h(0) minus the ȳ residual).  α₀ = Xᵀq̄₀/N then needs **no
        pass over the data**: (a·col_sum + b·col_y_sum)/N from the
        ingest-time column stats.  The loss is evaluated at 0 in float32;
        the sums accumulate in float64 on the host and are cast to float32
        on ``device``.  Agrees with the kernel ``fw_setup`` to float32
        tolerance (not bit for bit — use ``prepared()`` when exact replay
        matters).
        """
        from repro_torch.core.losses import get_loss
        from repro_torch.core.solvers.registry import check_device
        device = check_device(device)
        obj = get_loss(loss)
        stats = self.col_stats()
        inv_n = 1.0 / max(self.n, 1)
        zero = torch.zeros((), dtype=torch.float32)
        if obj.separable:
            # q̄₀ = h(0)·1; the engine keeps the ȳ residual out of q̄
            h0 = float(obj.split_grad(zero))
            alpha0 = h0 * stats.col_sum * inv_n - stats.col_y_sum * inv_n
            qbar0 = torch.full((self.n,), h0, dtype=torch.float32, device=device)
        else:
            # label-coupled: q̄₀ carries the full row gradient, no ȳ term
            a = float(obj.grad(zero, torch.tensor(0.0)))
            b = float(obj.grad(zero, torch.tensor(1.0))) - a
            alpha0 = (a * stats.col_sum + b * stats.col_y_sum) * inv_n
            y_host = np.asarray(self.labels(), np.float64)
            qbar0 = torch.from_numpy((a + b * y_host).astype(np.float32)).to(device)
        return (torch.zeros(self.n, dtype=torch.float32, device=device), qbar0,
                torch.from_numpy(np.asarray(alpha0).astype(np.float32)).to(device))


def _rows_per_block(shape, itemsize: int) -> int:
    row_bytes = itemsize * int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 \
        else itemsize
    return max(1, COPY_BLOCK_BYTES // max(row_bytes, 1))


def _load_npy(path: str, device) -> torch.Tensor:
    """A ``.npy`` file as a tensor on ``device``: read off the mapping in row
    blocks of ``COPY_BLOCK_BYTES``, each copied out of the mapping before it
    reaches torch (the mapping is read-only and is never shared)."""
    mm = np.load(path, mmap_mode="r")
    out = torch.empty(mm.shape, dtype=torch.from_numpy(np.zeros(0, mm.dtype)).dtype,
                      device=device)
    step = _rows_per_block(mm.shape, mm.dtype.itemsize)
    for lo in range(0, mm.shape[0], step):
        out[lo:lo + step].copy_(torch.from_numpy(np.array(mm[lo:lo + step])))
    return out


def _save_npy(path: str, t: torch.Tensor) -> None:
    """Write a tensor (any device) as a ``.npy`` file, copying it to the host
    in row blocks so a card-sized table never sits whole in host memory."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=t[:0].cpu().numpy().dtype,
                                   shape=tuple(t.shape))
    step = _rows_per_block(mm.shape, mm.dtype.itemsize)
    for lo in range(0, mm.shape[0], step):
        mm[lo:lo + step] = t[lo:lo + step].cpu().numpy()
    mm.flush()
    del mm


# ---------------------------------------------------------------------------
# DatasetRef — the name/path handle solvers accept in place of a matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DatasetRef:
    """A by-name or by-path reference to a stored dataset (+ optional split).

    ``solve(DatasetRef("rcv1_like"), config=...)`` — labels come from the
    store; ``split="train"/"test"`` selects the deterministic hash split.
    Named refs resolve through ``repro_torch.data.registry`` (generating and
    caching the dataset on first use); path refs open the store directly.
    """

    name: Optional[str] = None
    path: Optional[str] = None
    split: str = "all"            # all | train | test
    test_frac: float = 0.2
    salt: int = 0

    def __post_init__(self):
        if (self.name is None) == (self.path is None):
            raise ValueError("DatasetRef needs exactly one of name= or path=")
        if self.split not in ("all", "train", "test"):
            raise ValueError(f"unknown split {self.split!r}")

    def open(self) -> DatasetStore:
        if self.path is not None:
            return DatasetStore.open(self.path)
        from repro_torch.data.registry import load
        return load(self.name)

    def resolve(self):
        """→ (data source, labels): the whole store for ``split="all"`` (so
        padded/setup caches apply), or a materialized row subset."""
        store = self.open()
        if self.split == "all":
            return store, store.labels()
        train, test = store.split(self.test_frac, self.salt)
        return store.take(train if self.split == "train" else test)
