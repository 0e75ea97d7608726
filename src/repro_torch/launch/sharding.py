"""Sharding rules: leaf path + leaf shape → spec (port of ``repro.launch.sharding``).

MaxText-style named rules with a universal divisibility fallback: any dim
whose size does not divide the mesh axis is replicated instead (e.g.
minicpm's 36 heads or GQA kv = 8 against model = 16), and recorded in
``log`` with the JAX package's wording, so a dry run lists every fallback.

A tree here is an ordered mapping from the JAX package's leaf path
(``"params/blocks/attn/wq"``) to a leaf with ``.shape`` and ``.dtype`` (a
tensor on ``meta``): the port keeps a model's layer groups as lists of
per-layer dicts where JAX stacks them, so ``models/registry.py`` names each
stacked group once, at JAX's stacked shape, in JAX's flatten order.  Each
group then gets one spec, and at most one fallback line a JAX leaf.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of names (a tuple of one name is the name, as ``PartitionSpec``
writes it).  Rules are right-aligned like JAX's ``PartitionSpec``: a
rule written for the logical shape (D, F) applies to a stacked (L, D, F)
leaf with the leading dims replicated.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.launch.mesh import Mesh

Spec = Tuple[Any, ...]

# (path regex, right-aligned spec): first match wins.
_RULES: List[Tuple[str, Tuple]] = [
    # MoE expert-parallel weights (E, D, F) / (E, F, D): experts → model
    (r"moe/(w1|w2|w3)$", ("model", None, None)),
    (r"moe/router$", (None, None)),
    (r"moe/shared/(w1|w3)$", (None, "model")),
    (r"moe/shared/w2$", ("model", None)),
    # embeddings / head: vocab → model
    (r"embed$", ("model", None)),
    (r"head$", (None, "model")),
    # attention projections (megatron column/row parallel)
    (r"(wq|wuq|wk|wv|wuk|wuv)$", (None, "model")),
    (r"(wdq|wdkv)$", (None, None)),             # small latent down-projections
    (r"wo$", ("model", None)),
    # dense FFN
    (r"ffn/(w1|w3)$", (None, "model")),
    (r"ffn/w2$", ("model", None)),
    # mamba
    (r"in_proj$", (None, "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"x_proj$", ("model", None)),
    (r"dt_proj$", (None, "model")),
    (r"dt_bias$", ("model",)),
    (r"a_log$", ("model", None)),
    (r"d_skip$", ("model",)),
    (r"out_proj$", ("model", None)),
    # rg-lru
    (r"(in_x|in_gate)$", (None, "model")),
    (r"(w_r|w_i)$", (None, "model")),
    (r"lam$", ("model",)),
    (r"kind_r/out$", ("model", None)),
    # norms and everything else: replicated
    (r".*", ()),
]

# FSDP (ZeRO-3-style) rules: weights over BOTH mesh axes, so parameters and
# optimizer state scale as 1/(data·model).  embed/head stay vocab-(model-)
# sharded: the chunked CE loss touches the head once a chunk.
_RULES_FSDP: List[Tuple[str, Tuple]] = [
    (r"moe/(w1|w3)$", ("model", None, "data")),
    (r"moe/w2$", ("model", "data", None)),
    (r"moe/router$", (None, None)),
    (r"moe/shared/(w1|w3)$", ("data", "model")),
    (r"moe/shared/w2$", ("model", "data")),
    (r"embed$", ("model", None)),
    (r"head$", (None, "model")),
    (r"(wq|wuq|wk|wv|wuk|wuv)$", ("data", "model")),
    (r"(wdq|wdkv)$", ("data", None)),
    (r"wo$", ("model", "data")),
    (r"ffn/(w1|w3)$", ("data", "model")),
    (r"ffn/w2$", ("model", "data")),
    (r"in_proj$", ("data", "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"x_proj$", ("model", "data")),
    (r"dt_proj$", ("data", "model")),
    (r"dt_bias$", ("model",)),
    (r"a_log$", ("model", None)),
    (r"d_skip$", ("model",)),
    (r"out_proj$", ("model", "data")),
    (r"(in_x|in_gate)$", ("data", "model")),
    (r"(w_r|w_i)$", ("data", "model")),
    (r"lam$", ("model",)),
    (r"kind_r/out$", ("model", "data")),
    (r".*", ()),
]

# decode caches (right-aligned over the trailing dims); the alternatives are
# tried in order, and the first whose dims all divide wins (KV = 8 < model =
# 16 falls back to sharding head_dim instead).
_CACHE_RULES: List[Tuple[str, Any]] = [
    (r"(self_|cross_)?k$", [("data", None, "model", None),   # (B,S,KV,hd)
                            ("data", None, None, "model")]),
    (r"(self_|cross_)?v$", [("data", None, "model", None),
                            ("data", None, None, "model")]),
    (r"c$", [("data", None, "model")]),                      # MLA latent (B,S,kl)
    (r"kr$", [("data", None, None)]),
    (r"h$", [("data", "model", None)]),                      # mamba (B,di,N)
    (r"conv$", [("data", None, "model")]),                   # (B,K-1,di)
    (r"cross_len$", [()]),
    (r".*", [()]),
]


def _axes_size(ax, mesh: Mesh) -> Tuple[Tuple[str, ...], int]:
    axes = ax if isinstance(ax, tuple) else (ax,)
    total = 1
    for a in axes:
        total *= mesh.sizes[a]
    return axes, total


def _sanitize(spec: Tuple, shape: Tuple[int, ...], mesh: Mesh,
              log: Optional[list] = None, path: str = "") -> Spec:
    """Right-align, then drop any axis that doesn't divide its dim."""
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    full = full[: len(shape)]
    out = []
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        axes, total = _axes_size(ax, mesh)
        if dim % total == 0 and dim > 0:
            out.append(axes[0] if len(axes) == 1 else ax)
        else:
            out.append(None)
            if log is not None:
                log.append(f"{path}: dim {dim} % {axes}({total}) != 0 → replicated")
    return tuple(out)


def _spec_for(path: str, shape, mesh: Mesh, rules, log=None) -> Spec:
    # strip train-state / optimizer-state prefixes so m/v/stats reuse the
    # parameter's rule ("opt_state/m/blocks/attn/wq" → "blocks/attn/wq")
    stripped = re.sub(r"^(params/|opt_state/)+", "", path)
    stripped = re.sub(r"^(m|v|stats)/", "", stripped)
    is_vr = stripped.endswith("/vr")
    is_vc = stripped.endswith("/vc")
    stripped = re.sub(r"/(vr|vc|v)$", "", stripped) if (is_vr or is_vc) else stripped
    for pat, spec in rules:
        if re.search(pat, stripped):
            if is_vr:
                # row statistics: the parameter's shape less its last dim
                spec = tuple(spec[:-1]) if spec else ()
            elif is_vc:
                # column statistics: less its second-to-last dim
                spec = (tuple(s for i, s in enumerate(spec) if i != len(spec) - 2)
                        if len(spec) >= 2 else spec)
            return _sanitize(spec, shape, mesh, log, path)
    return ()


def params_shardings(tree: Mapping[str, Any], mesh: Mesh, log: Optional[list] = None, *,
                     fsdp=False) -> Dict[str, Spec]:
    """Specs for a params / optimizer-state / train-state tree.

    ``fsdp`` grades how far state is sharded over the data axis:

      False        params and optimizer state follow _RULES (model axis only).
      "zero2"      optimizer state doubly sharded; params model-axis only.
      "zero3_moe"  zero2, and the expert weights doubly sharded.
      True/"zero3" everything doubly sharded.
    """
    def pick_rules(path: str):
        is_opt = path.startswith("opt_state")
        if fsdp is False or fsdp is None:
            return _RULES
        if fsdp == "zero2":
            return _RULES_FSDP if is_opt else _RULES
        if fsdp == "zero3_moe":
            is_expert = re.search(r"moe/(w1|w2|w3)$", path) is not None
            return _RULES_FSDP if (is_opt or is_expert) else _RULES
        return _RULES_FSDP  # True / "zero3"

    return {p: _spec_for(p, tuple(leaf.shape), mesh, pick_rules(p), log)
            for p, leaf in tree.items()}


def _fits(spec, shape, mesh: Mesh) -> bool:
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    for dim, ax in zip(shape, full[: len(shape)]):
        if ax is None:
            continue
        _, total = _axes_size(ax, mesh)
        if dim % total != 0 or dim == 0:
            return False
    return True


def cache_shardings(tree: Mapping[str, Any], mesh: Mesh,
                    log: Optional[list] = None) -> Dict[str, Spec]:
    def leaf_spec(p: str, shape) -> Spec:
        for pat, alternatives in _CACHE_RULES:
            if re.search(pat, p):
                for spec in alternatives:
                    if _fits(spec, shape, mesh):
                        return _sanitize(spec, shape, mesh, None, p)
                # none fits fully: sanitize the first (per-dim fallback)
                return _sanitize(alternatives[0], shape, mesh, log, p)
        return ()

    return {p: leaf_spec(p, tuple(leaf.shape)) for p, leaf in tree.items()}


def batch_shardings(tree: Mapping[str, Any], mesh: Mesh, log: Optional[list] = None, *,
                    axes: Optional[Tuple[str, ...]] = None) -> Dict[str, Spec]:
    """Batch inputs: leading dim over (pod, data), or over ``axes`` when the
    full-DP layout also spreads the batch over "model"."""
    baxes = axes or (("pod", "data") if "pod" in mesh.axis_names else ("data",))
    baxes = tuple(a for a in baxes if a in mesh.axis_names)
    return {p: _sanitize((baxes,), tuple(leaf.shape), mesh, log, p) for p, leaf in tree.items()}


def replicated(mesh: Mesh) -> Spec:
    return ()


def shard_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` laid out by ``spec``."""
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    out = []
    for dim, ax in zip(shape, full):
        n = 1 if ax is None else _axes_size(ax, mesh)[1]
        out.append(-(-int(dim) // n))
    return tuple(out)


def device_bytes(tree: Mapping[str, Any], specs: Mapping[str, Spec], mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs``."""
    total = 0
    for p, leaf in tree.items():
        n = 1
        for s in shard_shape(tuple(leaf.shape), specs.get(p, ()), mesh):
            n *= s
        total += n * leaf.dtype.itemsize
    return total
