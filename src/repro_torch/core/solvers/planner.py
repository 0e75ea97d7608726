"""Cost-model execution planner of the port (``repro.core.solvers.planner``).

Three questions every solve and sweep answers before a kernel runs:

  1. **Which backend?**  ``FWConfig(backend="auto")`` picks from the
     problem's shape: a step of Alg 1 (``dense``) costs O(nnz + D), a step of
     Alg 2 (``torch_sparse``) the padded tile O(K_c·K_r + √D), priced with the
     three-term roofline (``repro_torch.roofline.roofline_terms``) fed with
     per-step FLOP and byte counts.  On the card the model holds no host
     time, which sets every solver step there, so it compares only measured
     steps with measured steps and else picks ``torch_sparse``.
  2. **Lanes or sequential?**  A sweep group runs as one lane-stacked chunk
     (one launch of each kernel serves every config of the group) or as
     sequential per-config solves sharing one setup.  Measured per-step
     costs that the batched driver records (``record_cost``) override the
     model when a matching observation exists.
  3. **What chunk length?**  ``steps/8`` clamped to [8, 256]
     (``stopping.default_chunk``).

The planner never changes results: every plan runs the same state machine
with the same keys; only scheduling differs.

The platform keys are the port's, ``torch-cuda`` and ``torch-cpu``
(``autotune.platform_of(config.device)``), never the JAX package's, and the
cost book records under the backend names the port registers
(``jax_sparse`` is read as ``torch_sparse``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.solvers.config import FWConfig
from repro_torch.core.solvers.stopping import default_chunk  # noqa: F401  (re-exported)
from repro_torch.roofline.analysis import roofline_terms

CPU_PLATFORM = "torch-cpu"
# The CPU rates fed to roofline_terms: deliberately conservative (one wide
# core of a shared container), the JAX package's figures; only ratios between
# candidate plans matter.  The card's rates are the roofline module's
# (NVIDIA H100 SXM, 700 W).
CPU_PEAK_FLOPS = 2.0e10
CPU_HBM_BW = 1.5e10
# One extra lane of a lane-stacked step, in sequential steps.  On the CPU the
# lane form loops the single-lane plain version, so a lane costs at least a
# sequential step; the JAX package's CPU figure (1.4) is kept, which makes
# the same choice.  On the card: the private sweep's wall in lanes over its
# wall in sequential solves, as chip_smoke.py's sweep phase measures it
# (B = 8, rcv1.binary shape, T = 500; second readings 0.322 and 0.346 in two
# runs on an NVIDIA H100 80GB HBM3 at 700 W, their mean; PERF.md §6).
CPU_VMAP_LANE_OVERHEAD = 1.4
ACCEL_VMAP_LANE_OVERHEAD = 0.33


@dataclasses.dataclass(frozen=True)
class ProblemStats:
    """Shape facts the cost model consumes (cheap to derive, never solves)."""

    n: int
    d: int
    nnz: int
    kc: int   # max column nnz (Alg-2 tile height)
    kr: int   # max row nnz (Alg-2 tile width)

    @property
    def density(self) -> float:
        return self.nnz / max(self.n * self.d, 1)


# manifest-derived stats per store, keyed by content hash
_STORE_STATS: Dict[str, ProblemStats] = {}


def store_stats(store) -> ProblemStats:
    """:class:`ProblemStats` of a ``DatasetStore`` from its metadata alone:
    n/d/nnz and the max row and column nnz from the manifest (older
    manifests: the column counts of the ingest pass and the shards' indptrs,
    memory-mapped).  Nothing materializes the matrix."""
    key = store.content_hash
    got = _STORE_STATS.get(key)
    if got is not None:
        return got
    kc = store.manifest.get("col_nnz_max")
    if kc is None:
        df = store.col_stats().df
        kc = int(df.max()) if df.size else 1
    kr = store.manifest.get("row_nnz_max")
    if kr is None:
        kr = 1
        for i in range(store.n_shards):
            indptr = np.load(store._shard_base(i) + ".indptr.npy", mmap_mode="r")
            if indptr.shape[0] > 1:
                kr = max(kr, int(np.diff(indptr).max()))
    stats = ProblemStats(n=store.n, d=store.d, nnz=store.nnz,
                         kc=max(int(kc), 1), kr=max(int(kr), 1))
    _STORE_STATS[key] = stats
    return stats


def data_stats(X) -> ProblemStats:
    """Derive :class:`ProblemStats` from any layout ``solve`` accepts."""
    from repro_torch.core.solvers.prepared import PreparedDataset
    from repro_torch.core.sparse.formats import HostCSR, PaddedCSC, PaddedCSR, TieredCSC
    if isinstance(X, PreparedDataset):
        X = X.pair
    if (isinstance(X, tuple) and len(X) == 2 and isinstance(X[0], PaddedCSR)
            and isinstance(X[1], (PaddedCSC, TieredCSC))):
        pcsr, pcsc = X
        n, d = pcsr.shape
        # a tiered CSC's tile height is the true max column nnz (the heavy tier)
        kc = pcsc.full_width if isinstance(pcsc, TieredCSC) else int(pcsc.indices.shape[1])
        return ProblemStats(n=n, d=d, nnz=int(pcsr.nnz.sum()), kc=kc,
                            kr=int(pcsr.indices.shape[1]))
    if isinstance(X, HostCSR):
        row_nnz = np.diff(X.indptr)
        col_nnz = np.bincount(X.indices, minlength=X.shape[1])
        return ProblemStats(n=X.shape[0], d=X.shape[1], nnz=X.nnz,
                            kc=int(col_nnz.max()) if X.nnz else 1,
                            kr=int(row_nnz.max()) if X.nnz else 1)
    if getattr(X, "content_hash", None) is not None and hasattr(X, "manifest"):
        return store_stats(X)
    if hasattr(X, "resolve"):                       # DatasetRef
        resolved, _ = X.resolve()
        return data_stats(resolved)
    arr = X.cpu().numpy() if hasattr(X, "cpu") else np.asarray(X)
    if arr.ndim == 2:
        nnz_mask = arr != 0
        row = nnz_mask.sum(axis=1)
        col = nnz_mask.sum(axis=0)
        return ProblemStats(n=arr.shape[0], d=arr.shape[1], nnz=int(nnz_mask.sum()),
                            kc=int(col.max()) if col.size else 1,
                            kr=int(row.max()) if row.size else 1)
    raise TypeError(f"cannot derive problem stats from {type(X).__name__}")


# ---------------------------------------------------------------------------
# per-step cost model (FLOPs / bytes per FW step, by backend)
# ---------------------------------------------------------------------------


def step_costs(stats: ProblemStats, backend: str) -> Tuple[float, float]:
    """(flops, bytes) of one FW step: Alg 1 O(nnz + N + D); Alg 2 the
    K_c×K_r tile, the two-level selection O(√D) and the O(K_c) refresh;
    ``torch_dense`` (``jax_dense``) also touches the D-wide sampler state."""
    n, d, nnz = stats.n, stats.d, stats.nnz
    if backend == "dense":
        flops = 4.0 * nnz + 4.0 * n + 6.0 * d
        bytes_ = 4.0 * (2.0 * nnz + 2.0 * n + 3.0 * d)
        return flops, bytes_
    tile = float(stats.kc) * float(stats.kr)
    sqrt_d = math.sqrt(max(d, 1))
    flops = 6.0 * tile + 4.0 * stats.kc + 3.0 * sqrt_d
    bytes_ = 4.0 * (3.0 * tile + 4.0 * stats.kc + 2.0 * sqrt_d)
    if _backend_name(backend) == "torch_dense":   # the D-wide sampler state
        flops += 2.0 * d
        bytes_ += 8.0 * d
    return flops, bytes_


def step_time_model(stats: ProblemStats, backend: str, platform: str) -> float:
    """Modelled seconds per FW step on ``platform`` (roofline bound)."""
    flops, bytes_ = step_costs(stats, backend)
    if platform == CPU_PLATFORM:
        terms = roofline_terms(flops=flops, bytes_accessed=bytes_, collective_bytes=0.0,
                               chips=1, peak_flops=CPU_PEAK_FLOPS, hbm_bw=CPU_HBM_BW)
    else:
        terms = roofline_terms(flops=flops, bytes_accessed=bytes_, collective_bytes=0.0,
                               chips=1)
    return float(terms["t_bound_s"])


# ---------------------------------------------------------------------------
# measured-cost book: observations beat the model
# ---------------------------------------------------------------------------

# (backend, mode, platform, loss, n-bucket, d-bucket) -> smoothed s/step/lane
_COSTBOOK: Dict[tuple, float] = {}
# keys whose first (build-tainted) observation has been discarded
_WARMED: set = set()


def _bucket(x: int) -> int:
    return int(math.log2(max(x, 1)))


def _backend_name(backend: str) -> str:
    from repro_torch.core.solvers.registry import BACKEND_ALIASES
    return BACKEND_ALIASES.get(backend, backend)


def _cost_key(backend: str, mode: str, platform: str, stats: ProblemStats,
              loss: str = "logistic") -> tuple:
    return (_backend_name(backend), mode, platform, loss, _bucket(stats.n), _bucket(stats.d))


def record_cost(backend: str, mode: str, platform: str, stats: ProblemStats,
                seconds_per_step_lane: float, *, loss: str = "logistic") -> None:
    """Feed an observed per-step-per-lane time back into the planner (the
    batched driver calls this after every group or chunk).

    The first observation per key is discarded: it carries the one-off cost
    of the process's first launches (the kernels' build at first use)."""
    key = _cost_key(backend, mode, platform, stats, loss)
    if key not in _WARMED:
        _WARMED.add(key)
        return
    prev = _COSTBOOK.get(key)
    _COSTBOOK[key] = (seconds_per_step_lane if prev is None
                      else 0.7 * prev + 0.3 * seconds_per_step_lane)
    _gauge_drift(backend, mode, platform, stats, loss, seconds_per_step_lane)


def record_measured(backend: str, mode: str, platform: str, stats: ProblemStats,
                    seconds_per_step_lane: float, *, loss: str = "logistic") -> None:
    """A steady-state observation (the autotuner's best-of-N timing): no
    first-observation discard, no blending — it becomes the book's entry."""
    key = _cost_key(backend, mode, platform, stats, loss)
    _WARMED.add(key)
    _COSTBOOK[key] = float(seconds_per_step_lane)
    _gauge_drift(backend, mode, platform, stats, loss, seconds_per_step_lane)


def _gauge_drift(backend: str, mode: str, platform: str, stats: ProblemStats,
                 loss: str, seconds_per_step_lane: float) -> None:
    """Measured seconds per step over the model's (> 1: the model is
    optimistic); evaluated only with telemetry on."""
    if not obs.enabled():
        return
    backend = _backend_name(backend)
    model = step_time_model(stats, backend, platform)
    if model > 0.0:
        obs.gauge("planner.drift", seconds_per_step_lane / model,
                  backend=backend, mode=mode, loss=loss)
    obs.observe("planner.step_seconds", seconds_per_step_lane, backend=backend, mode=mode)


def measured_cost(backend: str, mode: str, platform: str, stats: ProblemStats, *,
                  loss: str = "logistic") -> Optional[float]:
    return _COSTBOOK.get(_cost_key(backend, mode, platform, stats, loss))


def clear_costbook() -> None:
    _COSTBOOK.clear()
    _WARMED.clear()


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _platform(platform: Optional[str] = None, device: str = "cuda") -> str:
    if platform is not None:
        return platform
    from repro_torch.core.solvers.autotune import platform_of
    return platform_of(device)


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """How a sweep group executes — never *what* it computes.

    ``mode``: "vmap" runs the group lane-stacked (one launch of each kernel
    serves all its configs; cohort chunks with retirement when the configs
    can stop early); "sequential" runs per-config solves over one shared
    setup.  ``chunk_steps`` of None defers to the config's or the default.
    """

    mode: str = "auto"                   # auto | vmap | sequential
    chunk_steps: Optional[int] = None
    backend: Optional[str] = None        # filled for backend="auto" configs
    notes: str = ""

    def resolved_mode(self, platform: Optional[str] = None) -> str:
        if self.mode != "auto":
            return self.mode
        return "sequential" if _platform(platform) == CPU_PLATFORM else "vmap"


# Warm λ-segments of a path re-solve from the previous λ's iterate and get
# steps/4 (the JAX package's rule, read by the λ-path drivers, ``path.py``).
PATH_WARM_DIV = 4


def path_budgets(steps: int, n_lambdas: int) -> Tuple[int, ...]:
    """Per-λ step budgets of a warm-started path: the first λ cold at
    ``steps``, every later one ``steps // PATH_WARM_DIV`` clamped to [8, steps]."""
    if n_lambdas <= 0:
        return ()
    steps = int(steps)
    warm = max(1, min(steps, max(8, steps // PATH_WARM_DIV)))
    return (steps,) + (warm,) * (n_lambdas - 1)


def cohort_widths(width: int) -> Tuple[int, ...]:
    """Allowed cohort widths: powers of two down from the grid size.  A
    cohort that loses members re-enters the next bucket (the JAX package's
    compile buckets; the port keeps them, so a cohort's lanes step the same
    way in both packages)."""
    widths = []
    w = 1
    while w < width:
        widths.append(w)
        w *= 2
    widths.append(width)
    return tuple(sorted(set(widths), reverse=True))


def choose_backend(stats: ProblemStats, config: FWConfig,
                   platform: Optional[str] = None) -> str:
    """Resolve ``backend="auto"``: ``dense`` or ``torch_sparse``, whichever
    step is cheaper.  On the CPU, as in the JAX package: the measured cost
    (when the book has one for this shape and loss) or else the roofline
    model.  On the card both steps must be measured: the roofline there
    holds no host time and runs ~1,000× under a measured step, so against a
    model the pick stays ``torch_sparse``, the step the card runs fastest
    where both were measured (PERF.md §6).  A config that names a mesh would
    want the sharded engine, which is not ported."""
    if config.mesh is not None and tuple(config.mesh) != (1, 1):
        raise NotImplementedError(
            f"FWConfig.mesh={config.mesh!r} wants the sharded engine, which is not "
            "ported yet: see ROADMAP.md item A12 (sharded engine)")
    plat = _platform(platform, config.device)
    per_step = {b: measured_cost(b, "sequential", plat, stats, loss=config.loss)
                for b in ("dense", "torch_sparse")}
    if plat != CPU_PLATFORM and None in per_step.values():
        return "torch_sparse"
    per_step = {b: step_time_model(stats, b, plat) if got is None else got
                for b, got in per_step.items()}
    return "dense" if per_step["dense"] < per_step["torch_sparse"] else "torch_sparse"


def group_mode(stats: ProblemStats, group_size: int, plan: Optional[SolvePlan] = None,
               platform: Optional[str] = None, loss: str = "logistic",
               backend: str = "torch_sparse") -> str:
    """Lanes ("vmap") or sequential for one sweep group: measured costs win,
    then the lane-overhead model, then the platform default."""
    if plan is not None and plan.mode != "auto":
        return plan.mode
    if group_size < 2:
        return "sequential"
    plat = _platform(platform)
    seq = measured_cost(backend, "sequential", plat, stats, loss=loss)
    vm = measured_cost(backend, "vmap", plat, stats, loss=loss)
    if seq is not None and vm is not None:
        return "vmap" if vm < seq else "sequential"
    # a B-lane step costs lane·B sequential steps against B and ~5% loop
    # overhead: B cancels, so without measurements the choice is the
    # platform's constant
    lane = CPU_VMAP_LANE_OVERHEAD if plat == CPU_PLATFORM else ACCEL_VMAP_LANE_OVERHEAD
    return "vmap" if lane < 1.05 else "sequential"


def plan_for(X, configs: Sequence[FWConfig], platform: Optional[str] = None) -> SolvePlan:
    """One plan for a ``solve_many`` call (stats derived once from ``X``);
    the platform is the first config's device's unless given."""
    stats = data_stats(X)
    plat = _platform(platform, configs[0].device if configs else "cuda")
    steps = configs[0].steps if configs else 0
    backend = configs[0].backend if configs else "torch_sparse"
    mode = group_mode(stats, len(configs), platform=plat,
                      loss=configs[0].loss if configs else "logistic",
                      backend=_backend_name(backend) if backend != "auto" else "torch_sparse")
    return SolvePlan(mode=mode, chunk_steps=default_chunk(steps) if steps else None,
                     notes=f"platform={plat} n={stats.n} d={stats.d} "
                           f"nnz={stats.nnz} grid={len(configs)}")
