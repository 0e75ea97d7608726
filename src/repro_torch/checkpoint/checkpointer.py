"""Atomic npz snapshots of nested state (``repro.checkpoint.checkpointer``, npz part).

``save_pytree(tree, path, metadata)`` writes a nested dict / list / tuple of
numpy arrays, tensors or scalars as one ``.npz`` whose keys are the leaves'
paths joined by ``"/"``, in the JAX package's flattening order (dict keys
sorted, sequences by index, ``None`` holds no leaf), plus an optional
``<path>.meta.json``.  Both files land through ``<file>.tmp`` → fsync →
``os.replace``, so a crash mid-save never leaves a torn snapshot.  The layout
is the JAX package's byte for byte in keys and dtypes: each package restores
what the other wrote.

``Checkpointer`` (rotation, elastic re-placement onto a mesh) belongs to
training and is ROADMAP.md item A13.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any


def _leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {key: _as_numpy(leaf) for key, leaf in _leaves_with_paths(tree)}


def save_pytree(tree, path: str, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    flat = _flatten_with_paths(tree)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if metadata is not None:
        mtmp = path + ".meta.tmp"
        with open(mtmp, "w") as f:
            json.dump(metadata, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, path + ".meta.json")


def _rebuild(template, leaves: List):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return leaves.pop(0)


def restore_pytree(template, path: str):
    """Restore into the structure of ``template``.  Each leaf takes its
    template leaf's shape and dtype: a tensor leaf comes back as a tensor on
    the template leaf's device, any other leaf as a numpy array."""
    out = []
    with np.load(path) as data:
        for key, tmpl in _leaves_with_paths(template):
            arr = data[key]
            shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint mismatch at {key}: {arr.shape} vs {shape}")
            if isinstance(tmpl, torch.Tensor):
                out.append(torch.from_numpy(np.array(arr)).to(device=tmpl.device,
                                                               dtype=tmpl.dtype))
            else:
                out.append(arr.astype(np.asarray(tmpl).dtype))
    return _rebuild(template, out)
