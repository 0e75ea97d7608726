"""Tuning records of the port (``repro.core.solvers.autotune``, the record only).

A ``TuningRecord`` names one dataset's winning layout (the tiered CSC's
``ell_width``) and chunk length for (platform, backend, loss).  The dataset
store persists records under its ``cache/`` directory, guarded by its
content hash and ``TUNE_VERSION``; ``torch_sparse`` applies a record when one
exists (``backends.py``).  The record's JSON form is the JAX package's.

The port's platform keys are ``torch-cuda`` and ``torch-cpu`` (``platform_of``),
so a record that the JAX package wrote for ``cpu``, ``gpu`` or ``tpu``
never steers the port, nor the port's the JAX package.

The search itself (candidate widths, the parity probe, chunk timing) is
ROADMAP.md item A10; until then the port writes no record.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

TUNE_VERSION = 1


def platform_of(device) -> str:
    """The port's platform key for records on ``device``."""
    return f"torch-{torch.device(device).type}"


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One dataset's tuning winner for (platform, backend, loss).

    ``ell_width`` of None means the flat layout won; ``mesh`` is only set by
    the sharded engine's search.  Both per-iter timings are kept, as the
    JAX package's record keeps them.
    """

    content_hash: str
    platform: str
    backend: str
    loss: str
    ell_width: Optional[int] = None
    chunk_steps: Optional[int] = None
    mesh: Optional[Tuple[int, int]] = None
    per_iter_default_ms: float = 0.0
    per_iter_tuned_ms: float = 0.0
    pass_parity: bool = True
    version: int = TUNE_VERSION

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if self.mesh is not None:
            d["mesh"] = list(self.mesh)
        return d

    @classmethod
    def from_json(cls, d: dict) -> Optional["TuningRecord"]:
        if not isinstance(d, dict) or d.get("version") != TUNE_VERSION:
            return None
        d = dict(d)
        if d.get("mesh") is not None:
            d["mesh"] = tuple(int(v) for v in d["mesh"])
        try:
            return cls(**d)
        except TypeError:
            return None


def autotune(*args, **kwargs):
    """The layout/chunk search: not ported yet."""
    raise NotImplementedError("the autotune search is not ported yet: see ROADMAP.md item A10")
