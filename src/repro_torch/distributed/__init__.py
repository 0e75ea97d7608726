"""The sharded Frank-Wolfe engine on ``torch.distributed`` (``repro.distributed``):
the (a × b) block layout, its ingestion from stores, the rank grid and its
collectives, the engine and its 1×1 oracle."""
from repro_torch.distributed.block_sparse import (BlockAssembler,  # noqa: F401
                                                  BlockSparse, build_block_sparse)
from repro_torch.distributed.collectives import ShardMesh, make_mesh  # noqa: F401
from repro_torch.distributed.fw_shard import DistFWConfig, distributed_fw  # noqa: F401
