"""Carry the JAX package's state into the port, and the port's state out.

The solver's "parameters" are the padded design matrix, the ``fw_setup``
state and the loop carry; the LM's are its weights.  These functions take
the JAX package's objects as dicts of numpy arrays, keyed by the JAX
dataclass field names (``{f: np.asarray(getattr(obj, f)) for f in ...}``) or,
for the LM, as the ``lm_init`` pytree with numpy leaves, and return the
port's objects on ``device`` — so a run started in JAX can be continued by
the port, and both packages can run the same weights.  The port never
imports the JAX package; the caller does the conversion to numpy.
``carry_to_numpy`` is the way back.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.samplers.group_argmax import GroupArgmaxState
from repro_torch.core.samplers.two_level import TwoLevelSamplerState
from repro_torch.core.solvers.torch_sparse import FWCarry
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR, TieredCSC
from repro_torch.models.transformer import _split_groups
from repro_torch.train.tree import leaf_paths, leaves_with_paths

Fields = Mapping[str, object]


def _t(x, device, dtype=None) -> torch.Tensor:
    # always a copy: the port updates its state in place, and the caller's
    # arrays (often read-only views of JAX buffers) must not be written
    return torch.tensor(np.array(x, copy=True), dtype=dtype, device=device)


def _shape(f: Fields) -> Tuple[int, int]:
    n, d = f["shape"]
    return int(n), int(d)


def padded_csr(f: Fields, device="cuda") -> PaddedCSR:
    """``PaddedCSR`` from fields ``indices, values, nnz, shape``."""
    return PaddedCSR(_t(f["indices"], device, torch.int32), _t(f["values"], device,
                     torch.float32), _t(f["nnz"], device, torch.int32), _shape(f))


def padded_csc(f: Fields, device="cuda") -> PaddedCSC:
    """``PaddedCSC`` from fields ``indices, values, nnz, shape``."""
    return PaddedCSC(_t(f["indices"], device, torch.int32), _t(f["values"], device,
                     torch.float32), _t(f["nnz"], device, torch.int32), _shape(f))


def tiered_csc(f: Fields, device="cuda") -> TieredCSC:
    """``TieredCSC`` from fields ``indices, values, nnz, heavy_slot,
    heavy_indices, heavy_values, shape``."""
    return TieredCSC(
        indices=_t(f["indices"], device, torch.int32),
        values=_t(f["values"], device, torch.float32),
        nnz=_t(f["nnz"], device, torch.int32),
        heavy_slot=_t(f["heavy_slot"], device, torch.int32),
        heavy_indices=_t(f["heavy_indices"], device, torch.int32),
        heavy_values=_t(f["heavy_values"], device, torch.float32),
        shape=_shape(f))


def setup_state(setup, device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``fw_setup`` triple (v̄₀, q̄₀, α₀)."""
    return tuple(_t(x, device, torch.float32) for x in setup)


def sampler_state(f: Fields, d: int, device="cuda"):
    """``TwoLevelSamplerState`` from ``v, c`` or ``GroupArgmaxState`` from ``p, bound``."""
    if "v" in f:
        v = _t(f["v"], device, torch.float32)
        return TwoLevelSamplerState(v=v, c=_t(f["c"], device, torch.float32), d=d,
                                    touched=torch.zeros(v.shape[0], dtype=torch.int32,
                                                        device=device))
    return GroupArgmaxState(p=_t(f["p"], device, torch.float32),
                            bound=_t(f["bound"], device, torch.float32), d=d)


def fw_carry(f: Fields, d: int, device="cuda") -> FWCarry:
    """``FWCarry`` from fields ``w, w_m, g_tilde, vbar, qbar, alpha, sampler,
    key, done, stop_at``; ``sampler`` is itself a dict of fields and ``key``
    the uint32[2] raw key."""
    f32 = lambda name: _t(f[name], device, torch.float32)
    return FWCarry(
        w=f32("w"), w_m=f32("w_m"), g_tilde=f32("g_tilde"), vbar=f32("vbar"),
        qbar=f32("qbar"), alpha=f32("alpha"), sampler=sampler_state(f["sampler"], d, device),
        key=torch.as_tensor(np.asarray(f["key"]).astype(np.int64)),
        done=_t(f["done"], device, torch.bool),
        stop_at=_t(f["stop_at"], device, torch.int32))


def carry_to_numpy(carry: FWCarry) -> Dict[str, object]:
    """The port's carry as numpy fields, keyed as the JAX ``FWCarry``."""
    s = carry.sampler
    sampler = ({"v": s.v, "c": s.c} if isinstance(s, TwoLevelSamplerState)
               else {"p": s.p, "bound": s.bound})
    out = {name: getattr(carry, name).cpu().numpy() for name in
           ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha", "done", "stop_at")}
    out["sampler"] = {k: v.cpu().numpy() for k, v in sampler.items()}
    out["key"] = carry.key.numpy().astype(np.uint32)
    return out


def _weight(x, device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaves(tree):
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def stacked_groups(cfg) -> Dict[str, int]:
    """The pytree's layer groups stacked along axis 0, and their depths:
    rglru's ``blocks`` is a list of layers already (its layers differ)."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.dec_layers}
    if cfg.family == "hybrid":
        return {}
    lead, main = _split_groups(cfg)
    return {"lead_blocks": lead, "blocks": main}


def lm_params(params_np: Mapping[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """The port's LM parameters from the JAX package's ``lm_init`` pytree.

    ``params_np``: the pytree with numpy leaves (``jax.tree.map(np.asarray,
    params)``).  The scanned groups — ``lead_blocks`` (MoE configs' leading
    dense layers) and ``blocks`` of the decoders and mamba, ``enc_blocks``
    and ``dec_blocks`` of the encoder-decoder — stacked along axis 0, are
    unstacked into one dict per layer, so an MoE layer's ``(L, E, d, f)``
    expert stacks become ``(E, d, f)``; rglru's per-layer list stays a list.
    Weights keep their ``(d_in, d_out)`` orientation, which is the port's
    too.  Dtypes are kept (the router stays float32).
    """
    groups = stacked_groups(cfg)

    def convert(tree, layer=None):
        if isinstance(tree, Mapping):
            return {k: convert(v, layer) for k, v in tree.items()}
        if isinstance(tree, list):
            return [convert(v, layer) for v in tree]
        return _weight(tree if layer is None else np.asarray(tree)[layer], device)

    out = {k: convert(v) for k, v in params_np.items() if k not in groups}
    if cfg.family == "hybrid" and len(out["blocks"]) != cfg.n_layers:
        raise ValueError(f"lm_params: blocks has {len(out['blocks'])} layers, the config "
                         f"has {cfg.n_layers}")
    for name, n in groups.items():
        if name not in params_np and not n:
            continue
        stacked = {np.shape(a)[0] for a in _leaves(params_np.get(name, {}))}
        if stacked != {n}:
            raise ValueError(f"lm_params: {name} stack {sorted(stacked)} layers, the config "
                             f"has {n}")
        out[name] = [convert(params_np[name], i) for i in range(n)]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    try:                                    # JAX's bfloat16, where numpy knows it
        import ml_dtypes
        return bits.view(ml_dtypes.bfloat16)
    except ImportError:
        return bits.view("V2")


def _nest(flat: Mapping[str, Any]) -> Any:
    """A nested tree from ``"a/b/c"`` paths; a level whose keys are 0..n-1
    becomes a list (JAX's list of rglru layers)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) and \
                sorted(map(int, node)) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _flat_paths(tree) -> Dict[str, Any]:
    return dict(leaves_with_paths(tree))


def lm_params_to_numpy(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The JAX ``lm_init`` pytree (numpy leaves) of the port's LM parameters:
    the inverse of ``lm_params``, each of ``stacked_groups(cfg)`` stacked
    along axis 0 (bfloat16 as ``ml_dtypes.bfloat16`` where it is installed,
    else its raw two bytes)."""
    groups = [name for name, n in stacked_groups(cfg).items() if n]
    flat = {path: _to_numpy(torch.stack([t.detach() for t in ts]) if
                            path.split("/")[0] in groups else ts[0])
            for path, ts in leaf_paths(params, groups)}
    return _nest(flat)


def opt_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX optimizer state (numpy leaves) of the port's: adamw's ``{"m",
    "v", "count"}``, adafactor's ``{"stats", "count"}`` with ``{"vr", "vc"}``
    or ``{"v"}`` at each parameter's path (the port keeps them in JAX's
    layout, keyed by path)."""
    out: Dict[str, Any] = {"count": _to_numpy(state["count"])}
    for name in ("m", "v", "stats"):
        if name in state:
            out[name] = _nest({k: _to_numpy(v) for k, v in _flat_paths(state[name]).items()})
    return out


def opt_state(tree_np: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's (numpy leaves)."""
    out: Dict[str, Any] = {"count": _t(tree_np["count"], device, torch.int32)}
    for name in ("m", "v"):
        if name in tree_np:
            out[name] = {k: _t(v, device, torch.float32)
                         for k, v in _flat_paths(tree_np[name]).items()}
    if "stats" in tree_np:
        stats: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in _flat_paths(tree_np["stats"]).items():
            path, stat = k.rsplit("/", 1)
            stats.setdefault(path, {})[stat] = _t(v, device, torch.float32)
        out["stats"] = stats
    return out
