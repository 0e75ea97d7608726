"""Backend registry of the port — the single entry point for a solve.

    from repro_torch.core.solvers import FWConfig, solve
    result = solve(X, y, FWConfig(lam=30.0, steps=500))          # on cuda
    result = solve(X, y, FWConfig(lam=30.0, steps=500, device="cpu"))

One backend is registered in this slice, ``torch_sparse`` (``backends.py``).
:func:`solve` refuses what the slice does not implement, coerces ``X`` — a
``HostCSR``, a dense numpy matrix, or a padded pair — into the padded pair
on ``config.device``, and translates queue names through
``QUEUE_ALIASES["device"]`` as the JAX registry does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.solvers.config import (FWConfig, FWResult, check_gap_certificate,
                                             check_supported)
from repro_torch.core.sparse.formats import (HostCSR, PaddedCSC, PaddedCSR, TieredCSC,
                                             dense_to_host, host_to_padded)


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered solver: adapter fn + the data layout and queues it speaks."""

    name: str
    fn: Callable  # (padded pair, y, config) -> FWResult
    queues: Mapping[str, str]
    default_queue: Optional[str]


_REGISTRY: Dict[str, Backend] = {}

# fib_heap ≡ group_argmax ≡ argmax: exact max of |α|.
# bsls ≡ two_level ≡ gumbel: the DP exponential mechanism.
QUEUE_ALIASES: Mapping[str, Mapping[str, str]] = {
    "device": {
        "two_level": "two_level", "group_argmax": "group_argmax",
        "bsls": "two_level", "gumbel": "two_level",
        "fib_heap": "group_argmax", "argmax": "group_argmax",
    },
}


def register(name: str, *, queues: Mapping[str, str],
             default_queue: Optional[str]) -> Callable:
    """Decorator: add ``fn(padded pair, y, config) -> FWResult`` under ``name``."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = Backend(name=name, fn=fn, queues=queues,
                                  default_queue=default_queue)
        return fn
    return deco


def _ensure_builtins() -> None:
    import repro_torch.core.solvers.backends  # noqa: F401  (registers on import)


def available_backends() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> Backend:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"backend {name!r} is not ported (available: {', '.join(available_backends())});"
            " the other engines are ROADMAP.md item A9") from None


def _is_padded_pair(X) -> bool:
    return (isinstance(X, tuple) and len(X) == 2 and isinstance(X[0], PaddedCSR)
            and isinstance(X[1], (PaddedCSC, TieredCSC)))


def as_padded(X, device="cuda"):
    """→ ``(PaddedCSR, PaddedCSC | TieredCSC)`` on ``device``."""
    if _is_padded_pair(X):
        return X[0].to(device), X[1].to(device)
    if isinstance(X, HostCSR):
        return host_to_padded(X, device)
    if isinstance(X, np.ndarray) and X.ndim == 2:
        return host_to_padded(dense_to_host(X), device)
    raise TypeError("X must be a HostCSR, a 2-D numpy matrix, or a (PaddedCSR, "
                    f"PaddedCSC | TieredCSC) pair; got {type(X).__name__}")


def resolve_queue(backend: Backend, config: FWConfig) -> FWConfig:
    """Fill in / translate ``config.queue`` for ``backend``."""
    if config.queue is None:
        return dataclasses.replace(config, queue=backend.default_queue)
    try:
        native = backend.queues[config.queue]
    except KeyError:
        raise ValueError(
            f"backend {backend.name!r} does not support queue {config.queue!r}; "
            f"accepted: {', '.join(sorted(backend.queues))}") from None
    return dataclasses.replace(config, queue=native)


def check_device(device: str) -> torch.device:
    """The solve's device; a CUDA device must exist (no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FWConfig.device={device!r} but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def solve(X, y, config: Optional[FWConfig] = None, **overrides) -> FWResult:
    """Run the configured Frank-Wolfe backend on (X, y).

    ``X``: HostCSR, dense (N, D) numpy matrix, or a padded pair; ``y``: (N,)
    labels in {0, 1}, numpy or torch.  Keyword overrides apply on top of ``config``.
    """
    config = config or FWConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    check_supported(config)
    check_gap_certificate(config)
    device = check_device(config.device)
    backend = get_backend(config.backend)
    config = resolve_queue(backend, config)
    data = as_padded(X, device)
    if isinstance(y, torch.Tensor):
        y = y.to(device=device, dtype=torch.float32)
    else:
        y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    return backend.fn(data, y, config)
