"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpointer``).

``save_pytree(tree, path, metadata)`` writes a nested dict / list / tuple of
numpy arrays, tensors or scalars as one ``.npz`` whose keys are the leaves'
paths joined by ``"/"``, in the JAX package's flattening order (dict keys
sorted, sequences by index, ``None`` holds no leaf), plus an optional
``<path>.meta.json``.  Both files land through ``<file>.tmp`` → fsync →
``os.replace``, so a crash mid-save never leaves a torn snapshot.  The layout
is the JAX package's byte for byte in keys and dtypes: each package restores
what the other wrote.  bfloat16 is stored as JAX's npz stores it, two raw
bytes a value (``|V2``).

A ``train.TrainState`` is written under the JAX ``TrainState``'s keys and
shapes: ``step``, ``params/<path>`` with each of the state's ``stacked``
layer groups stacked along a leading axis as JAX stacks them (``params/
blocks/attn/wq`` of shape (L, d, h·hd)), and ``opt_state/<path>`` (the
port's optimizer state is already in JAX's layout).  So a training
checkpoint written by either package restores in the other.

``Checkpointer``: ``step_<n>.npz`` in one directory, atomic saves, rotation
keeping the latest ``keep`` and every multiple of ``keep_every`` (cold
anchors), ``latest_step``, ``restore`` into a template with a shape check.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaf_paths, leaves_with_paths, tree_unflatten

Pytree = Any


def _is_train_state(tree) -> bool:
    return all(hasattr(tree, f) for f in ("step", "params", "opt_state", "stacked"))


def _layout(tree) -> List[Tuple[str, Any]]:
    """[(key, leaf)] in the JAX package's layout; a stacked group's leaf is
    the list of its layers' tensors."""
    if not _is_train_state(tree):
        return leaves_with_paths(tree)
    stacked = set(tree.stacked)
    return ([("step", tree.step)]
            + [("params/" + path, ts if path.split("/")[0] in stacked else ts[0])
               for path, ts in leaf_paths(tree.params, tree.stacked)]
            + [("opt_state/" + key, leaf) for key, leaf in leaves_with_paths(tree.opt_state)])


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, list):
        leaf = torch.stack([t.detach() for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # JAX's npz: two raw bytes a value
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _like(arr: np.ndarray, tmpl) -> Any:
    """``arr`` as its template leaf: a tensor of the leaf's dtype on its
    device, else a numpy array of its dtype."""
    if isinstance(tmpl, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    return arr.astype(np.asarray(tmpl).dtype)


def save_pytree(tree, path: str, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    flat = {key: _as_numpy(leaf) for key, leaf in _layout(tree)}
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


def restore_pytree(template, path: str):
    """Restore into the structure of ``template`` (a tree, or a
    ``TrainState`` read from the JAX layout).  Each leaf takes its template
    leaf's shape and dtype: a tensor leaf comes back as a tensor on the
    template leaf's device (a parameter that required grad requires it
    again), any other leaf as a numpy array."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key, tmpl in _layout(template):
            arr = data[key]
            if tuple(arr.shape) != _shape(tmpl):
                raise ValueError(f"checkpoint mismatch at {key}: {arr.shape} vs {_shape(tmpl)}")
            got = [_like(arr[i], t) for i, t in enumerate(tmpl)] if isinstance(tmpl, list) \
                else _like(arr, tmpl)
            for g, t in zip(got, tmpl) if isinstance(tmpl, list) else [(got, tmpl)]:
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    g.requires_grad_(True)
            out[key] = got
    if not _is_train_state(template):
        return tree_unflatten(template, out.values())
    # the parameters: each JAX leaf back into its layers (by tensor identity)
    by_id = {}
    for path, ts in leaf_paths(template.params, template.stacked):
        got = out["params/" + path]
        for t, g in zip(ts, got if isinstance(got, list) else [got]):
            by_id[id(t)] = g

    def params(t):
        if isinstance(t, dict):
            return {k: params(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(params(v) for v in t)
        return by_id[id(t)]

    opt = [v for k, v in out.items() if k.startswith("opt_state/")]
    return type(template)(step=out["step"], params=params(template.params),
                          opt_state=tree_unflatten(template.opt_state, opt),
                          stacked=template.stacked)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, keep_every: int = 0):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".npz"):
                try:
                    steps.append(int(name[5:-4]))
                except ValueError:
                    pass
        return sorted(steps)

    def save(self, state, metadata: Optional[dict] = None) -> str:
        if hasattr(state, "step"):
            step = int(np.asarray(_as_numpy(state.step)))
        else:
            step = int((metadata or {}).get("step", 0))
        meta = dict(metadata or {})
        meta["step"] = step
        path = os.path.join(self.dir, f"step_{step}.npz")
        save_pytree(state, path, meta)
        self._rotate()
        return path

    def _rotate(self):
        steps = self._step_dirs()
        if len(steps) <= self.keep:
            return
        for s in steps[: -self.keep]:
            if self.keep_every and s % self.keep_every == 0:
                continue  # cold-storage anchor
            for suffix in (".npz", ".npz.meta.json"):
                p = os.path.join(self.dir, f"step_{s}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def latest_step(self) -> Optional[int]:
        steps = self._step_dirs()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """(the state at ``step``, or the latest, restored into ``template``;
        its metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}.npz")
        state = restore_pytree(template, path)
        meta_path = path + ".meta.json"
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return state, meta
