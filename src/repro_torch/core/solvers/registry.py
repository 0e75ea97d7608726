"""Backend registry of the port — the single entry point for a solve.

    from repro_torch.core.solvers import FWConfig, solve
    result = solve(X, y, FWConfig(lam=30.0, steps=500))          # on cuda
    result = solve(X, y, FWConfig(lam=30.0, steps=500, device="cpu"))

Four backends are registered (``backends.py``), every single-device engine
of the JAX package: ``dense`` (Alg 1, the default), ``torch_dense`` (Alg 2,
dense vector updates; the JAX name ``jax_dense`` selects it),
``host_sparse`` (Alg 2, the faithful float64 host loop) and
``torch_sparse`` (Alg 2 through the kernels; ``jax_sparse`` selects it).
:func:`solve` refuses what the port does not implement, coerces ``X`` — a
``HostCSR``, a dense numpy matrix, a padded pair, or a
``repro_torch.data.store`` ``DatasetStore``/``DatasetRef`` (whose labels
stand in for ``y``) — into the backend's data format (``dense``,
``padded`` on ``config.device``, or ``host``) and translates queue names
through ``QUEUE_ALIASES`` as the JAX registry does.  A store reaches ``torch_sparse`` as a
``PreparedDataset``: its cached padded layout and setup state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.solvers.config import (FWConfig, FWResult, check_gap_certificate,
                                             check_supported)
from repro_torch.core.solvers.prepared import PreparedDataset
from repro_torch.core.sparse.formats import (HostCSR, PaddedCSC, PaddedCSR, TieredCSC,
                                             coo_to_host, dense_to_host, host_to_padded)


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered solver: adapter fn + the data layout and queues it speaks."""

    name: str
    fn: Callable  # (data, y, config) -> FWResult
    data_format: str  # "dense" | "padded" | "host": the layout solve() coerces X into
    queues: Mapping[str, str]
    default_queue: Optional[str]
    # an engine that runs T steps without looking at a clock refuses
    # max_seconds; declared so that admission (the fit service) refuses such
    # a config before it charges any budget
    supports_max_seconds: bool = True
    supports_screening: bool = False  # a chunk loop whose pair may change (screen_every)
    supports_path: bool = False       # a chunk loop a λ-path re-enters (lambdas)

    def prepare(self, X, device="cuda"):
        """Coerce ``X`` into this backend's data layout on ``device``."""
        return _COERCE[self.data_format](X, device)


_REGISTRY: Dict[str, Backend] = {}

# fib_heap ≡ group_argmax ≡ argmax: exact max of |α|.
# bsls ≡ two_level ≡ gumbel: the DP exponential mechanism.
QUEUE_ALIASES: Mapping[str, Mapping[str, str]] = {
    "host": {
        "fib_heap": "fib_heap", "argmax": "argmax", "noisy_max": "noisy_max",
        "bsls": "bsls", "group_argmax": "fib_heap", "two_level": "bsls",
        "gumbel": "bsls",
    },
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
BACKEND_ALIASES: Mapping[str, str] = {"jax_sparse": "torch_sparse",
                                       "jax_dense": "torch_dense"}


def register(name: str, *, data_format: str, queues: Mapping[str, str],
             default_queue: Optional[str], supports_max_seconds: bool = True,
             supports_screening: bool = False, supports_path: bool = False) -> Callable:
    """Decorator: add ``fn(data, y, config) -> FWResult`` under ``name``."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = Backend(name=name, fn=fn, data_format=data_format, queues=queues,
                                  default_queue=default_queue,
                                  supports_max_seconds=supports_max_seconds,
                                  supports_screening=supports_screening,
                                  supports_path=supports_path)
        return fn
    return deco


def _ensure_builtins() -> None:
    import repro_torch.core.solvers.backends  # noqa: F401  (registers on import)


def available_backends() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


# the JAX package's backends the port does not have yet → their ROADMAP.md item
UNPORTED_BACKENDS: Mapping[str, str] = {
    "jax_shard": "A12 (sharded engine)",
}


def get_backend(name: str) -> Backend:
    """The registered backend ``name`` (``jax_sparse`` is ``torch_sparse``,
    ``jax_dense`` is ``torch_dense``).

    A JAX backend the port lacks raises ``NotImplementedError`` naming its
    ROADMAP.md item; any other unknown name, ``ValueError``.  ``"auto"`` is
    resolved by the planner before this is reached (``solve``,
    ``solve_many``)."""
    _ensure_builtins()
    name = BACKEND_ALIASES.get(name, name)
    if name in _REGISTRY:
        return _REGISTRY[name]
    available = ", ".join(available_backends())
    if name in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (available: {available}): "
            f"see ROADMAP.md item {UNPORTED_BACKENDS[name]}")
    raise ValueError(f"unknown solver backend {name!r}; available: {available}"
                     + ("; 'auto' is resolved by solve/solve_many" if name == "auto" else ""))


def _is_padded_pair(X) -> bool:
    return (isinstance(X, tuple) and len(X) == 2 and isinstance(X[0], PaddedCSR)
            and isinstance(X[1], (PaddedCSC, TieredCSC)))


def _as_store(X):
    """The ``DatasetStore`` behind ``X``, or None (lazy import, no cycle)."""
    from repro_torch.data.store import DatasetStore
    return X if isinstance(X, DatasetStore) else None


def resolve_data(X, y=None):
    """Resolve a ``DatasetRef``/``DatasetStore`` ``X`` into (source, labels).

    Plain matrices pass through unchanged (``y`` then required).  A ref with
    ``split="all"`` resolves to its open ``DatasetStore`` so the coercion
    can reuse the store's cached padded layout and setup state; train/test
    refs materialize the row subset.  An explicitly passed ``y`` always wins
    over the store's labels.
    """
    from repro_torch.data.store import DatasetRef, DatasetStore
    if isinstance(X, DatasetRef):
        X, ref_y = X.resolve()
        y = ref_y if y is None else y
    elif isinstance(X, DatasetStore):
        y = X.labels() if y is None else y
    if y is None:
        raise TypeError(
            "y is required unless X is a DatasetRef or DatasetStore "
            "(which carry their own labels)")
    return X, y


def _on_device(prep: PreparedDataset, device) -> PreparedDataset:
    if prep.device != torch.device(device):
        raise ValueError(f"the PreparedDataset lives on {prep.device}, the solve on {device}; "
                         "prepare the store on the solve's device")
    return prep


def as_host_csr(X) -> HostCSR:
    """→ ``HostCSR``: stores read their shards (mmap, zero-copy per shard),
    padded layouts are rebuilt from their live lanes, never as N×D."""
    if isinstance(X, HostCSR):
        return X
    store = _as_store(X)
    if store is not None:
        return store.to_host_csr()
    if isinstance(X, PreparedDataset):
        X = X.pair
    if _is_padded_pair(X):
        pcsr = X[0]
        idx, val = pcsr.indices.cpu().numpy(), pcsr.values.cpu().numpy().astype(np.float64)
        nnz = pcsr.nnz.cpu().numpy()
        mask = np.arange(idx.shape[1])[None, :] < nnz[:, None]
        rows = np.broadcast_to(np.arange(idx.shape[0])[:, None], idx.shape)
        return coo_to_host(rows[mask], idx[mask], val[mask], pcsr.shape)
    if isinstance(X, (np.ndarray, torch.Tensor)) and X.ndim == 2:
        x = X.cpu().numpy() if isinstance(X, torch.Tensor) else X
        return dense_to_host(np.asarray(x))
    raise TypeError("X must be a HostCSR, a 2-D matrix, a (PaddedCSR, PaddedCSC) pair, "
                    f"or a DatasetStore/DatasetRef; got {type(X).__name__}")


def as_padded(X, device="cuda"):
    """→ ``(PaddedCSR, PaddedCSC | TieredCSC)`` on ``device``, or a
    ``PreparedDataset`` for dataset stores (the same pair plus the persisted
    setup cache)."""
    if isinstance(X, PreparedDataset):
        return _on_device(X, device)
    store = _as_store(X)
    if store is not None:
        return store.prepared(device)
    if _is_padded_pair(X):
        return X[0].to(device), X[1].to(device)
    if isinstance(X, HostCSR):
        return host_to_padded(X, device)
    if isinstance(X, np.ndarray) and X.ndim == 2:
        return host_to_padded(dense_to_host(X), device)
    raise TypeError("X must be a HostCSR, a 2-D numpy matrix, a (PaddedCSR, "
                    "PaddedCSC | TieredCSC) pair, or a DatasetStore/DatasetRef; "
                    f"got {type(X).__name__}")


def as_dense(X, device="cuda"):
    """→ a dense float32 ``(N, D)`` tensor on ``device``, or a padded pair
    (moved to ``device``), which Alg 1 consumes through the spmv kernels.

    A ``HostCSR`` — and a store, through its shards — is scattered on the
    device: the float32 values equal the JAX package's
    ``jnp.asarray(X.to_dense(), float32)`` without an N×D float64 copy on
    the host.  A ``PreparedDataset`` gives its padded pair.
    """
    store = _as_store(X)
    if store is not None:
        # the same arrays the in-memory path sees → identical iterates
        X = store.to_host_csr()
    if isinstance(X, PreparedDataset):
        return _on_device(X, device).pair
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
    raise TypeError("X must be a HostCSR, a 2-D matrix, a (PaddedCSR, PaddedCSC | "
                    f"TieredCSC) pair, or a DatasetStore/DatasetRef; got {type(X).__name__}")


_COERCE = {"dense": as_dense, "padded": as_padded,
           # the host engine computes on the host whatever the device
           "host": lambda X, device: as_host_csr(X)}


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


def check_screening_support(backend: Backend, config: FWConfig) -> None:
    """Refuse ``screen_every`` on a backend without a chunk loop whose pair
    may change between chunks, before any compute."""
    if config.screen_every > 0 and not backend.supports_screening:
        raise ValueError(
            f"backend {backend.name!r} does not support chunk-boundary "
            "screening (screen_every > 0): it has no host-driven chunk loop "
            "with mutable problem geometry — use the dense or torch_sparse "
            "backend, or set screen_every=0")


def check_path_support(backend: Backend, config: FWConfig) -> None:
    """Refuse ``lambdas`` on a backend without a chunk loop that a λ-path
    can re-enter with its carry, before any compute."""
    if config.lambdas is not None and not backend.supports_path:
        raise ValueError(
            f"backend {backend.name!r} does not support warm-started λ-path "
            "(homotopy) solving (lambdas=...): it has no re-enterable chunked "
            "driver that can carry the iterate across λ segments — use the "
            "dense or torch_sparse backend, or solve each λ separately")


def labels_on(y, device) -> torch.Tensor:
    """Labels (numpy or torch) as a float32 tensor on ``device``."""
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)


def check_device(device: str) -> torch.device:
    """The run's device; a CUDA device must exist (no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def solve(X, y=None, config: Optional[FWConfig] = None, **overrides) -> FWResult:
    """Run the configured Frank-Wolfe backend on (X, y).

    ``X``: HostCSR, dense (N, D) numpy matrix, a padded pair, or a
    ``DatasetStore``/``DatasetRef`` (``y`` then defaults to the store's
    labels); ``y``: (N,) labels in {0, 1}, numpy or torch.  Keyword
    overrides apply on top of ``config``.  ``backend="auto"`` lets the
    planner pick ``dense`` or ``torch_sparse`` from the problem's shape
    (``planner.choose_backend``).  A config with ``lambdas`` is a λ-path:
    ``solve`` returns ``path.solve_path``'s ``PathResult``.  With telemetry
    on (``repro_torch.obs``) the call records the JAX package's spans
    (``solve``, ``solve.plan``, ``solve.coerce``, ``solve.run``) and counter
    (``solve.calls``); the iterates are the same either way.
    """
    config = config or FWConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    check_supported(config)
    if config.lambdas is not None:
        from repro_torch.core.solvers.path import solve_path
        return solve_path(X, y, config=config)
    with obs.span("solve", loss=config.loss, steps=config.steps) as sp:
        check_gap_certificate(config)
        if config.screen_every:
            from repro_torch.core.solvers.screening import check_screen_config
            check_screen_config(config)
        device = check_device(config.device)
        X, y = resolve_data(X, y)
        if config.backend == "auto":
            with obs.span("solve.plan"):
                from repro_torch.core.solvers.planner import choose_backend, data_stats
                config = dataclasses.replace(
                    config, backend=choose_backend(data_stats(X), config))
        backend = get_backend(config.backend)
        check_screening_support(backend, config)
        config = resolve_queue(backend, config)
        sp.set(backend=backend.name, queue=config.queue)
        obs.count("solve.calls", backend=backend.name)
        with obs.span("solve.coerce", layout=backend.data_format):
            data = backend.prepare(X, device)
            y = labels_on(y, device)
        with obs.span("solve.run", backend=backend.name):
            return backend.fn(data, y, config)
