"""Block ingestion for the ``jax_shard`` backend (``repro.distributed.ingest``).

``ShardSource`` is what the registry's ``blocks`` coercion returns: a thin
handle over the caller's data that defers the (a × b) block build until the
grid is known (it lives on ``FWConfig.mesh``, not on the data), then keeps
one ``BlockSparse`` per grid so sweeps, the fit service and repeated solves
never bucket again.

Two paths build blocks:

  * **in memory**: any matrix the registry turns into a ``HostCSR`` goes
    through ``build_block_sparse``;
  * **dataset store**: the shards stream one mmap ``HostCSR`` view at a time
    into ``BlockAssembler`` (lane counts, then fills with running pointers),
    so the store never densifies through one concatenated host matrix.  The
    layout persists under the store's ``cache/blocks-{a}x{b}.*`` (the JAX
    package's files, guarded by the content hash) and is read back on warm
    opens.  With more than one rank in the default process group, rank 0
    builds and saves and the others load after a barrier.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sparse.formats import HostCSR
from repro_torch.distributed.block_sparse import (BlockAssembler, BlockSparse, LocalBlock,
                                                  build_block_sparse)


def _shard_coo(row_start: int, csr: HostCSR):
    """(global rows, cols, vals) COO view of one store shard."""
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64) + row_start, np.diff(csr.indptr))
    return rows, csr.indices, csr.data


def _assemble(store, a: int, b: int) -> BlockSparse:
    cached = store.blocks_load(a, b)
    if cached is not None:
        return cached
    n, d = store.shape
    asm = BlockAssembler(n, d, a, b)
    for row_start, csr, _ in store.iter_shards():
        asm.count(*_shard_coo(row_start, csr)[:2])
    asm.alloc()
    for row_start, csr, _ in store.iter_shards():
        asm.fill(*_shard_coo(row_start, csr))
    blocks = asm.finish()
    store.blocks_save(a, b, blocks)
    return blocks


def blocks_from_store(store, a: int, b: int) -> BlockSparse:
    """Map a ``DatasetStore``'s shards onto an (a × b) ``BlockSparse``,
    through the store's blocks cache; lane order equals
    ``build_block_sparse(store.to_host_csr(), a, b)``.  Every rank of a
    multi-rank default group calls this together: rank 0 loads or builds
    (and saves), then the others load what it saved."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return _assemble(store, a, b)
    blocks = _assemble(store, a, b) if dist.get_rank() == 0 else None
    dist.barrier()
    if blocks is None:
        blocks = store.blocks_load(a, b)
        if blocks is None:
            raise RuntimeError(f"rank {dist.get_rank()}: rank 0 saved no blocks-{a}x{b} cache")
    return blocks


@dataclasses.dataclass
class ShardSource:
    """Deferred block coercion: one of (csr, store), a per-grid memo of the
    host blocks and of this rank's block on its device (so repeated solves,
    sweeps and the fit service copy a block to the card once)."""

    shape: Tuple[int, int]
    csr: Optional[HostCSR] = None
    store: Optional[object] = None            # repro_torch.data.store.DatasetStore
    _blocks: Dict[Tuple[int, int], BlockSparse] = dataclasses.field(default_factory=dict)
    _local: Dict[tuple, LocalBlock] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_any(cls, X) -> "ShardSource":
        """Coerce anything ``solve`` accepts into a ``ShardSource``."""
        if isinstance(X, cls):
            return X
        from repro_torch.data.store import DatasetStore
        if isinstance(X, DatasetStore):
            return cls(shape=X.shape, store=X)
        from repro_torch.core.solvers.registry import as_host_csr
        csr = as_host_csr(X)
        return cls(shape=csr.shape, csr=csr)

    def blocks(self, a: int, b: int) -> BlockSparse:
        key = (int(a), int(b))
        if key not in self._blocks:
            if self.store is not None:
                self._blocks[key] = blocks_from_store(self.store, *key)
            else:
                self._blocks[key] = build_block_sparse(self.csr, *key)
        return self._blocks[key]

    def local(self, a: int, b: int, ai: int, bj: int, device) -> LocalBlock:
        """Block (ai, bj) of the (a × b) grid on ``device``."""
        key = (int(a), int(b), int(ai), int(bj), str(torch.device(device)))
        if key not in self._local:
            self._local[key] = self.blocks(a, b).local(ai, bj, device)
        return self._local[key]
