"""Nested dict / list trees of tensors, with the JAX package's leaf paths.

``leaves_with_paths`` flattens in the JAX package's order (dict keys sorted,
sequences by index, ``None`` holds no leaf) and names each leaf by its keys
joined with ``"/"``, as ``repro.checkpoint`` names them.  The port keeps a
model's layer groups as lists of per-layer dicts where JAX stacks them along
a leading axis; ``leaf_paths(tree, stacked)`` names every leaf by its JAX
path (``"blocks/attn/wq"``) and gathers the layers of each group named in
``stacked`` under one path, so the optimizer state and checkpoints take
JAX's layout.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Sequence, Tuple

import torch


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(template, leaves: Iterable):
    """``template``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def leaf_paths(tree, stacked: Iterable[str] = ()) -> List[Tuple[str, List[torch.Tensor]]]:
    """[(JAX path, tensors)]: one tensor a path, or for a top-level group in
    ``stacked`` (a list of per-layer dicts of one structure) the group's
    layers in order under the path JAX gives their stacked leaf."""
    if not isinstance(tree, dict):
        return [(path, [leaf]) for path, leaf in leaves_with_paths(tree)]
    out: List[Tuple[str, List[torch.Tensor]]] = []
    for key in sorted(tree):
        value = tree[key]
        if key in set(stacked) and isinstance(value, (list, tuple)):
            layers = [leaves_with_paths(layer) for layer in value]
            out += [(f"{key}/{path}", [leaves[i][1] for leaves in layers])
                    for i, (path, _) in enumerate(layers[0] if layers else [])]
        else:
            out += [(path, [leaf]) for path, leaf in leaves_with_paths(value, (str(key),))]
    return out


def stacked_shape(path: str, tensors: Sequence[torch.Tensor], stacked: Iterable[str]) -> tuple:
    """The shape of the JAX leaf at ``path``."""
    lead = (len(tensors),) if path.split("/")[0] in set(stacked) else ()
    return lead + tuple(tensors[0].shape)
