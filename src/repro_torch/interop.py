"""Carry the JAX package's state into the port, and the port's state out.

The system has no model weights; its "parameters" are the padded design
matrix, the ``fw_setup`` state and the loop carry.  These functions take the
JAX package's objects as dicts of numpy arrays, keyed by the JAX dataclass
field names (``{f: np.asarray(getattr(obj, f)) for f in ...}``), and return
the port's objects on ``device`` — so a run started in JAX can be continued
by the port.  The port never imports the JAX package; the caller does the
conversion to numpy.  ``carry_to_numpy`` is the way back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.samplers.group_argmax import GroupArgmaxState
from repro_torch.core.samplers.two_level import TwoLevelSamplerState
from repro_torch.core.solvers.torch_sparse import FWCarry
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR, TieredCSC

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
