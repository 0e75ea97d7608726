"""Optimizers and LR schedules (port of ``repro.train.optimizer``).

* ``adamw``     — float32 moments.
* ``adafactor`` — factored second moments (rank-1 row/col statistics for
  leaves of two or more dimensions), no first moment.
* ``make_schedule`` — wsd (minicpm's warmup-stable-decay), cosine, constant.

Plain functions on tensors over the parameter tree, the JAX package's
arithmetic: the optimizer state is float32, each update is computed in
float32 and cast back to the parameter's dtype.  Fused ``torch.optim``
classes round differently and are not used.

Layout.  The port keeps a model's layer groups as lists of per-layer dicts;
the JAX package stacks them along a leading axis.  The state is keyed by
the JAX paths of ``train/tree.py``'s ``leaf_paths`` (the groups named in
``stacked`` gathered), each entry shaped as JAX's stacked leaf, so
it is JAX's state leaf for leaf (``interop.opt_state_to_numpy``), and
adafactor's statistics and update clipping — which reduce over the whole
stacked leaf — are JAX's.  ``update`` writes the new parameters and state
in place (the parameters are autograd leaves) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import torch

from repro_torch.train.tree import leaf_paths, leaves_with_paths, stacked_shape

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[..., Dict[str, Any]]
    update: Callable[..., Tuple[Tree, Dict[str, Any]]]
    name: str = ""


def _stack(tensors: Sequence[torch.Tensor], is_stacked: bool) -> torch.Tensor:
    """The JAX leaf of ``tensors`` in float32."""
    return torch.stack([t.float() for t in tensors]) if is_stacked else tensors[0].float()


def _write(tensors: Sequence[torch.Tensor], value: torch.Tensor, is_stacked: bool) -> None:
    for i, t in enumerate(tensors):
        t.copy_(value[i] if is_stacked else value)


def _groups(params, grads, stacked) -> List[Tuple[str, List[torch.Tensor], List[torch.Tensor], bool]]:
    """(path, parameter tensors, gradient tensors, stacked?) per JAX leaf."""
    stacked = tuple(stacked)
    ps, gs = leaf_paths(params, stacked), leaf_paths(grads, stacked)
    if [p for p, _ in ps] != [p for p, _ in gs]:
        raise ValueError("optimizer: the gradients' tree is not the parameters'")
    return [(path, pt, gt, path.split("/")[0] in stacked) for (path, pt), (_, gt) in zip(ps, gs)]


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g², each leaf's sum in float32)."""
    leaves = [leaf for _, leaf in leaves_with_paths(grads)]
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in float32 and cast
    back to each leaf's dtype, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(tree):
        if isinstance(tree, dict):
            return {k: clip(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clip(v) for v in tree)
        return (tree.float() * scale).to(tree.dtype)

    return clip(grads), norm


def _device(params) -> torch.device:
    leaves = leaves_with_paths(params)
    return leaves[0][1].device if leaves else torch.device("cpu")


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params, stacked: Iterable[str] = ()):
        m, v = {}, {}
        for path, ts in leaf_paths(params, stacked):
            shape = stacked_shape(path, ts, stacked)
            m[path] = torch.zeros(shape, dtype=F32, device=ts[0].device)
            v[path] = torch.zeros(shape, dtype=F32, device=ts[0].device)
        return {"m": m, "v": v, "count": torch.zeros((), dtype=torch.int32,
                                                      device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr: float, stacked: Iterable[str] = ()):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - _f32(b1, c.device) ** c
        bc2 = 1.0 - _f32(b2, c.device) ** c
        for path, pts, gts, is_stacked in _groups(params, grads, stacked):
            ms, vs = state["m"][path], state["v"][path]
            for i, (p, g) in enumerate(zip(pts, gts)):
                m_i, v_i = (ms[i], vs[i]) if is_stacked else (ms, vs)
                g = g.float()
                m_new = b1 * m_i + (1 - b1) * g
                v_new = b2 * v_i + (1 - b2) * torch.square(g)
                step = (m_new / bc1.to(g.device)) / (torch.sqrt(v_new / bc2.to(g.device)) + eps)
                step = step + weight_decay * p.float()
                p.copy_((p.float() - lr * step).to(p.dtype))
                m_i.copy_(m_new)
                v_i.copy_(v_new)
        state["count"].copy_(count)
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_rate: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params, stacked: Iterable[str] = ()):
        stats = {}
        for path, ts in leaf_paths(params, stacked):
            shape = stacked_shape(path, ts, stacked)
            dev = ts[0].device
            if _factored(shape):
                stats[path] = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                               "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                                 device=dev)}
            else:
                stats[path] = {"v": torch.zeros(shape, dtype=F32, device=dev)}
        return {"stats": stats, "count": torch.zeros((), dtype=torch.int32,
                                                      device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr: float, stacked: Iterable[str] = ()):
        count = state["count"] + 1
        beta = 1.0 - count.float() ** (-decay_rate)
        for path, pts, gts, is_stacked in _groups(params, grads, stacked):
            s = state["stats"][path]
            g = _stack(gts, is_stacked)
            b = beta.to(g.device)
            g2 = torch.square(g) + eps
            if _factored(g.shape):
                vr = b * s["vr"] + (1 - b) * g2.mean(-1)
                vc = b * s["vc"] + (1 - b) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                r = (vr / denom)[..., None]
                u = g * torch.rsqrt(r * vc[..., None, :] + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = b * s["v"] + (1 - b) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            # update clipping (RMS over the whole JAX leaf)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p = _stack(pts, is_stacked)
            if weight_decay:
                u = u + weight_decay * p
            _write(pts, (p - lr * u).to(pts[0].dtype), is_stacked)
        state["count"].copy_(count)
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")


def get_optimizer(name: str) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[name]()


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def make_schedule(kind: str, peak_lr: float, total_steps: int,
                  warmup: int = 0, decay_frac: float = 0.1) -> Callable[[int], float]:
    """Returns step → lr (a float, the JAX package's float32 arithmetic).
    ``wsd`` = warmup / stable / decay (MiniCPM)."""
    warmup = max(warmup, 1)
    f = lambda x: torch.tensor(x, dtype=F32)

    def warm(s):
        return peak_lr * torch.clamp((s + 1.0) / warmup, max=1.0)

    def wsd(s):
        decay_start = total_steps * (1.0 - decay_frac)
        decay = peak_lr * torch.clamp(
            1.0 - (s - decay_start) / max(total_steps - decay_start, 1.0), min=0.0)
        return warm(s) if float(s) < decay_start else torch.minimum(warm(s), decay)

    def cosine(s):
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = peak_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return warm(s) if float(s) < warmup else cos

    fn = {"wsd": wsd, "cosine": cosine, "constant": warm}[kind]
    return lambda step: float(fn(f(float(step))))
