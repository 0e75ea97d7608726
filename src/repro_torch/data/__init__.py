"""Datasets of the port: synthetic generators, LIBSVM text I/O, the sharded
on-disk store and the named-dataset registry (``repro.data`` counterpart;
``ShardedLoader`` is ROADMAP.md item A13 and refuses use)."""
from repro_torch.data.loader import ShardedLoader  # noqa: F401
from repro_torch.data.registry import available_datasets, load, register_dataset  # noqa: F401
from repro_torch.data.sparse_io import LibsvmChunk, iter_libsvm, write_libsvm  # noqa: F401
from repro_torch.data.store import ColumnStats, DatasetRef, DatasetStore  # noqa: F401
from repro_torch.data.synthetic import lm_batches, make_sparse_classification  # noqa: F401
