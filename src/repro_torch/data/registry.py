"""Named-dataset registry (copy of ``repro.data.registry`` on the port's
generator): the paper's Table-2 regimes as cached stores.

``load("rcv1_like")`` returns a ``DatasetStore`` for a synthetic twin of the
named paper dataset — generated through the port's
``make_sparse_classification`` (the JAX package's matrix and labels for the
same seed) on first use, materialized through the store, and opened from
disk ever after.

The specs, the cache root (``$REPRO_DATA_DIR`` when set, else
``~/.cache/repro/datasets``) and the spec fingerprint recorded in the
manifest are the JAX package's, so a named store that either package
generated serves both; a spec change invalidates the cached store.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from repro_torch.data.store import DatasetStore


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Generator parameters for one named synthetic dataset."""

    name: str
    n: int
    d: int
    nnz_per_row: float
    informative: int
    dense_features: int = 0
    seed: int = 0
    rows_per_shard: int = 4096

    def fingerprint(self) -> dict:
        return dataclasses.asdict(self)

    def generate(self):
        """(HostCSR, y) via the paper-matched synthetic generator."""
        from repro_torch.data.synthetic import make_sparse_classification
        X, y, _ = make_sparse_classification(
            n=self.n, d=self.d, nnz_per_row=self.nnz_per_row,
            informative=self.informative, dense_features=self.dense_features,
            seed=self.seed)
        return X, y


# Table-2 twins at bench scale (the JAX package's specs, field for field).
_REGISTRY: Dict[str, DatasetSpec] = {}


def register_dataset(spec: DatasetSpec) -> DatasetSpec:
    _REGISTRY[spec.name] = spec
    return spec


for _spec in (
    DatasetSpec("rcv1_like", n=2_000, d=4_800, nnz_per_row=40.0,
                informative=64),
    DatasetSpec("news20_like", n=1_000, d=135_000, nnz_per_row=110.0,
                informative=128),
    DatasetSpec("url_like", n=4_000, d=32_000, nnz_per_row=30.0,
                informative=64, dense_features=24),
    # CPU-friendly URL twin: same dense-informative-block structure, sized so
    # the padded CSC (D × max col nnz — the dense block pins that at N) stays
    # well under 100 MB for the ingest bench and the workflow example.
    DatasetSpec("url_small_like", n=1_500, d=8_000, nnz_per_row=25.0,
                informative=32, dense_features=16),
    DatasetSpec("web_like", n=1_200, d=166_000, nnz_per_row=260.0,
                informative=128),
    DatasetSpec("kdda_like", n=2_000, d=202_000, nnz_per_row=12.0,
                informative=64),
):
    register_dataset(_spec)


def available_datasets() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_spec(name: str) -> DatasetSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; available: "
                         f"{', '.join(available_datasets())}") from None


def data_root(root: Optional[str] = None) -> str:
    if root is not None:
        return root
    env = os.environ.get("REPRO_DATA_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro", "datasets")


def load(name: str, root: Optional[str] = None) -> DatasetStore:
    """Open the named dataset's store, generating + ingesting on first use."""
    spec = get_spec(name)
    path = os.path.join(data_root(root), name)
    if DatasetStore.exists(path):
        store = DatasetStore.open(path)
        if store.manifest.get("source") == spec.fingerprint():
            return store
        # spec changed since this store was materialized: rebuild
    X, y = spec.generate()
    return DatasetStore.from_arrays(
        path, X, y, rows_per_shard=spec.rows_per_shard,
        source=spec.fingerprint())
