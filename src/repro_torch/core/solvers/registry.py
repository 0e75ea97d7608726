"""Backend registry of the port — the single entry point for a solve.

    from repro_torch.core.solvers import FWConfig, solve
    result = solve(X, y, FWConfig(lam=30.0, steps=500))          # on cuda
    result = solve(X, y, FWConfig(lam=30.0, steps=500, device="cpu"))

Two backends are registered (``backends.py``): ``dense`` (Alg 1, the
default, as in the JAX package) and ``torch_sparse`` (Alg 2; the JAX name
``jax_sparse`` is accepted for it).  :func:`solve` refuses what the port
does not implement, coerces ``X`` — a ``HostCSR``, a dense numpy matrix, or
a padded pair — into the backend's data format on ``config.device``, and
translates queue names through ``QUEUE_ALIASES`` as the JAX registry does.
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
    fn: Callable  # (data, y, config) -> FWResult
    data_format: str  # "dense" | "padded": the layout solve() coerces X into
    queues: Mapping[str, str]
    default_queue: Optional[str]

    def prepare(self, X, device="cuda"):
        """Coerce ``X`` into this backend's data layout on ``device``."""
        return _COERCE[self.data_format](X, device)


_REGISTRY: Dict[str, Backend] = {}

# fib_heap ≡ group_argmax ≡ argmax: exact max of |α|.
# bsls ≡ two_level ≡ gumbel: the DP exponential mechanism.
QUEUE_ALIASES: Mapping[str, Mapping[str, str]] = {
    "device": {
        "two_level": "two_level", "group_argmax": "group_argmax",
        "bsls": "two_level", "gumbel": "two_level",
        "fib_heap": "group_argmax", "argmax": "group_argmax",
    },
    # Alg 1 has no queue; queue names map onto its `selection` rule.
    "selection": {
        "argmax": "argmax", "fib_heap": "argmax", "group_argmax": "argmax",
        "noisy_max": "noisy_max",
        "gumbel": "gumbel", "bsls": "gumbel", "two_level": "gumbel",
    },
}

# the JAX package's backend names that a port backend serves
BACKEND_ALIASES: Mapping[str, str] = {"jax_sparse": "torch_sparse"}


def register(name: str, *, data_format: str, queues: Mapping[str, str],
             default_queue: Optional[str]) -> Callable:
    """Decorator: add ``fn(data, y, config) -> FWResult`` under ``name``."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = Backend(name=name, fn=fn, data_format=data_format, queues=queues,
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
        return _REGISTRY[BACKEND_ALIASES.get(name, name)]
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


def as_dense(X, device="cuda"):
    """→ a dense float32 ``(N, D)`` tensor on ``device``, or a padded pair
    (moved to ``device``), which Alg 1 consumes through the spmv kernels.

    A ``HostCSR`` is scattered on the device: the float32 values equal the
    JAX package's ``jnp.asarray(X.to_dense(), float32)`` without an N×D
    float64 copy on the host.
    """
    if _is_padded_pair(X):
        return X[0].to(device), X[1].to(device)
    if isinstance(X, HostCSR):
        out = torch.zeros(X.shape, dtype=torch.float32, device=device)
        rows = torch.from_numpy(X.row_ids()).to(device)
        cols = torch.from_numpy(X.indices).to(device)
        out[rows, cols] = torch.from_numpy(X.data.astype(np.float32)).to(device)
        return out
    if isinstance(X, (np.ndarray, torch.Tensor)) and X.ndim == 2:
        return torch.as_tensor(X, dtype=torch.float32, device=device)
    raise TypeError("X must be a HostCSR, a 2-D matrix, or a (PaddedCSR, "
                    f"PaddedCSC | TieredCSC) pair; got {type(X).__name__}")


_COERCE = {"dense": as_dense, "padded": as_padded}


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
    data = backend.prepare(X, device)
    if isinstance(y, torch.Tensor):
        y = y.to(device=device, dtype=torch.float32)
    else:
        y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    return backend.fn(data, y, config)
