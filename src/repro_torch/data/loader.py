"""Batch loader (``repro.data.loader`` counterpart): not ported yet.

The JAX ``ShardedLoader`` places LM batches onto a mesh for
``launch/train.py``; it moves with the training scaffolding, ROADMAP.md
item A13.
"""
from __future__ import annotations


class ShardedLoader:
    """Placeholder that refuses use until the training part is ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedLoader is not ported yet: it feeds training, ROADMAP.md item A13")
