"""Per-dataset layout/chunk autotuner of the port (``repro.core.solvers.autotune``).

Text-like designs have power-law column popularity, so the flat
``PaddedCSC``'s pad width (the exact max column nnz) is far above the
99th-percentile column.  This module searches the JAX package's small,
bounded space per dataset **without changing the arithmetic**:

  * **tier width** — ``TieredCSC`` splits the flat CSC at width ``k``: a
    narrow (D, k) table plus a full-width table for the columns wider than
    ``k``.  Every candidate must pass a **bitwise parity probe** (coords, w
    and gaps identical to the flat layout, private and non-private) before
    it is timed; the flat layout always competes, and a candidate wins only
    if it is faster.
  * **chunk_steps** — the chunked driver's re-entry length.

The kernels' launch parameters are not searched (nor are they by the JAX
package).  Timings are best of three after a warm run.  A winner persists as
a :class:`TuningRecord` in the ``DatasetStore``'s ``cache/`` (content hash +
platform + backend + loss) and is replayed on warm opens without a search;
its per-step time also feeds the planner's cost book (``record_measured``).

The port's platform keys are ``torch-cuda`` and ``torch-cpu``
(``platform_of``), so a record that the JAX package wrote for ``cpu``,
``gpu`` or ``tpu`` never steers the port, nor the port's the JAX package.
The record's JSON form is the JAX package's.  For the sharded engine
(``tune_jax_shard``) the search is over the (a × b) grids that the default
process group allows, by time alone (every grid takes the same coordinates).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.solvers.config import FWConfig

TUNE_VERSION = 1
# bounded search: at most this many tier-width candidates per dataset
MAX_WIDTH_CANDIDATES = 4
# chunk lengths the chunked-driver search tries (plus the default)
CHUNK_CANDIDATES = (16, 32, 64)


def platform_of(device) -> str:
    """The port's platform key for records on ``device``."""
    return f"torch-{torch.device(device).type}"


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One dataset's tuning winner for (platform, backend, loss).

    ``ell_width`` of None means the flat layout won; ``mesh`` is only set by
    the sharded engine's search.  Both per-iter timings are kept, as the
    JAX package's record keeps them.
    """

    content_hash: str
    platform: str
    backend: str
    loss: str
    ell_width: Optional[int] = None
    chunk_steps: Optional[int] = None
    mesh: Optional[Tuple[int, int]] = None
    per_iter_default_ms: float = 0.0
    per_iter_tuned_ms: float = 0.0
    pass_parity: bool = True
    version: int = TUNE_VERSION

    @property
    def speedup(self) -> float:
        return self.per_iter_default_ms / max(self.per_iter_tuned_ms, 1e-12)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if self.mesh is not None:
            d["mesh"] = list(self.mesh)
        return d

    @classmethod
    def from_json(cls, d: dict) -> Optional["TuningRecord"]:
        if not isinstance(d, dict) or d.get("version") != TUNE_VERSION:
            return None
        d = dict(d)
        if d.get("mesh") is not None:
            d["mesh"] = tuple(int(v) for v in d["mesh"])
        try:
            return cls(**d)
        except TypeError:
            return None


def candidate_widths(pcsc, max_candidates: int = MAX_WIDTH_CANDIDATES) -> List[int]:
    """Power-of-two tier widths worth probing: from the first power of two at
    or above the 90th-percentile column nnz up to (exclusive) the flat pad
    width.  Bounded, and empty when the layout has no tail to split."""
    full = int(pcsc.indices.shape[1])
    cn = pcsc.nnz.cpu().numpy()
    if full <= 8 or cn.size == 0:
        return []
    lo = max(8, int(np.percentile(cn, 90)))
    cands = []
    w = 8
    while w < full and len(cands) < max_candidates:
        if w >= lo:
            cands.append(w)
        w *= 2
    return cands


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scan_once(pcsr, csc, setup, y_scan, *, steps, loss, lam, em_scale, private, seed=0):
    from repro_torch import prng
    from repro_torch.core.solvers.torch_sparse import fw_scan
    w, gaps, coords, _ = fw_scan(pcsr, csc, *setup, lam, em_scale, prng.PRNGKey(seed), 0.0,
                                 y_scan, steps=steps, loss=loss, private=private)
    _sync(w.device)
    return w, gaps, coords


def _labels(y, device) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)


def probe_parity(pcsr, pcsc_default, csc_candidate, y, *, loss: str, steps: int = 32,
                 lam: float = 20.0, setup=None) -> bool:
    """The exactness gate: the candidate layout must reproduce the flat
    layout's (w, gaps, coords) **bitwise**, on a private and a non-private
    run."""
    from repro_torch.core.losses import get_loss
    from repro_torch.core.solvers.torch_sparse import em_scale_for, fw_setup
    y32 = _labels(y, pcsr.device)
    if setup is None:
        setup = fw_setup(pcsr, y32, loss=loss, pcsc=pcsc_default)
    y_scan = None if get_loss(loss).separable else y32
    for private in (False, True):
        cfg = FWConfig(steps=steps, epsilon=1.0, delta=1e-6,
                       queue="two_level" if private else "group_argmax")
        kw = dict(steps=steps, loss=loss, lam=lam, private=private,
                  em_scale=em_scale_for(cfg, pcsr.shape[0]))
        ref = _scan_once(pcsr, pcsc_default, setup, y_scan, **kw)
        got = _scan_once(pcsr, csc_candidate, setup, y_scan, **kw)
        if not all(_bitwise_equal(r, g) for r, g in zip(ref, got)):
            return False
    return True


def _time_per_iter_ms(fn, steps: int, repeats: int = 3) -> float:
    """Best-of-N steady-state per-step time; ``fn`` must synchronise."""
    fn()                                 # warm: first launches excluded
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best / steps * 1e3


def _time_layout(pcsr, csc, setup, y_scan, *, steps, loss, lam, em_scale, private) -> float:
    kw = dict(steps=steps, loss=loss, lam=lam, em_scale=em_scale, private=private)
    return _time_per_iter_ms(lambda: _scan_once(pcsr, csc, setup, y_scan, **kw), steps)


def _tune_chunk(pcsr, csc, setup, y_scan, *, steps, loss, lam, em_scale,
                private) -> Optional[int]:
    """The chunked driver's re-entry length: a short chunked run timed at
    each candidate, the fastest kept (None: the default won)."""
    from repro_torch import prng
    from repro_torch.core.solvers.stopping import default_chunk
    from repro_torch.core.solvers.torch_sparse import fw_carry_init, fw_scan_chunk

    def run_chunked(chunk: int):
        carry = fw_carry_init(pcsr.shape[1], pcsr.values.dtype, *setup, em_scale,
                              prng.PRNGKey(0), private=private)
        t0 = 0
        while t0 < steps:
            c = min(chunk, steps - t0)
            carry, _ = fw_scan_chunk(pcsr, csc, carry, lam, em_scale, 0.0, t0, y_scan,
                                     steps=c, loss=loss, private=private, early_stop=True)
            t0 += c
        _sync(carry.w.device)

    base = default_chunk(steps)
    cands = sorted({min(c, steps) for c in (base,) + CHUNK_CANDIDATES})
    timed = {c: _time_per_iter_ms(lambda c=c: run_chunked(c), steps) for c in cands}
    best = min(timed, key=timed.get)
    return None if best == base else int(best)


def _feed_planner(backend: str, stats, per_iter_ms: float, *, loss: str, platform: str,
                  modes: Sequence[str] = ("sequential",)) -> None:
    from repro_torch.core.solvers.planner import record_measured
    for mode in modes:
        record_measured(backend, mode, platform, stats, per_iter_ms / 1e3, loss=loss)


def tune_torch_sparse(pcsr, pcsc, y, *, loss: str = "logistic", steps: int = 24,
                      probe_steps: int = 32, lam: float = 20.0, content_hash: str = "",
                      platform: Optional[str] = None, setup=None,
                      tune_chunk: bool = True) -> TuningRecord:
    """Search tier widths (and the chunk length) for ``torch_sparse`` on the
    pair's device.

    Candidates that fail the bitwise parity probe are dropped before any
    timing; the flat layout always stays eligible, so the tuner returns a
    layout that is exact and at least as fast as measured.  A candidate's
    time is the worse of a private and a non-private run of ``steps``.
    """
    from repro_torch.core.losses import get_loss
    from repro_torch.core.solvers.planner import data_stats
    from repro_torch.core.solvers.torch_sparse import em_scale_for, fw_setup
    from repro_torch.core.sparse.formats import tiered_from_padded
    plat = platform or platform_of(pcsr.device)
    y32 = _labels(y, pcsr.device)
    if setup is None:
        setup = fw_setup(pcsr, y32, loss=loss, pcsc=pcsc)
    y_scan = None if get_loss(loss).separable else y32
    cfg = FWConfig(steps=steps, epsilon=1.0, delta=1e-6, queue="two_level")
    em_private = em_scale_for(cfg, pcsr.shape[0])
    kw = dict(steps=steps, loss=loss, lam=lam)

    def per_iter(csc) -> float:
        # both selection rules, the worse kept: the tuned layout must not
        # slow either the private or the non-private step
        return max(_time_layout(pcsr, csc, setup, y_scan, em_scale=1.0, private=False, **kw),
                   _time_layout(pcsr, csc, setup, y_scan, em_scale=em_private, private=True,
                                **kw))

    default_ms = per_iter(pcsc)
    obs.event("autotune.candidate", backend="torch_sparse", loss=loss, candidate="flat",
              per_iter_ms=default_ms, parity=True)
    best_width, best_ms = None, default_ms
    for width in candidate_widths(pcsc):
        cand = tiered_from_padded(pcsc, width)
        if not probe_parity(pcsr, pcsc, cand, y32, loss=loss, steps=probe_steps, lam=lam,
                            setup=setup):
            obs.event("autotune.candidate", backend="torch_sparse", loss=loss,
                      candidate=f"tiered-{width}", parity=False)
            continue                      # exactness gate: never eligible
        ms = per_iter(cand)
        obs.event("autotune.candidate", backend="torch_sparse", loss=loss,
                  candidate=f"tiered-{width}", per_iter_ms=ms, parity=True)
        if ms < best_ms:
            best_width, best_ms = width, ms
    winner = tiered_from_padded(pcsc, best_width) if best_width is not None else pcsc
    chunk = (_tune_chunk(pcsr, winner, setup, y_scan, em_scale=em_private, private=True,
                         **kw) if tune_chunk else None)
    _feed_planner("torch_sparse", data_stats((pcsr, pcsc)), best_ms, loss=loss, platform=plat)
    obs.event("autotune.winner", backend="torch_sparse", loss=loss, ell_width=best_width,
              chunk_steps=chunk, per_iter_ms=best_ms,
              speedup=default_ms / max(best_ms, 1e-12))
    return TuningRecord(content_hash=content_hash, platform=plat, backend="torch_sparse",
                        loss=loss, ell_width=best_width, chunk_steps=chunk, mesh=None,
                        per_iter_default_ms=default_ms, per_iter_tuned_ms=best_ms,
                        pass_parity=True)


tune_jax_sparse = tune_torch_sparse   # the JAX package's name


def shard_grids() -> List[Tuple[int, int]]:
    """The grids ``jax_shard`` can run here: 1×1 (every rank alone), and
    every (a, b) with a·b = the default process group's world size."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return sorted({(1, 1)} | {(a, world // a) for a in range(1, world + 1) if world % a == 0})


def tune_jax_shard(src, y, *, loss: str = "logistic", steps: int = 24, lam: float = 20.0,
                   content_hash: str = "", platform: Optional[str] = None,
                   device: str = "cuda") -> TuningRecord:
    """Search (a, b) block grids for the sharded engine (``shard_grids``: just
    1×1 in one process).  Every grid takes the same coordinates, so only
    time decides; the winner also feeds the planner's cost book under the
    ``jax_shard`` key.  Every rank of the group runs the search together."""
    from repro_torch.core.solvers.jax_shard import shard_fw
    from repro_torch.core.solvers.planner import data_stats
    dev = torch.device(device)
    plat = platform or platform_of(dev)
    timings = {}
    for a, b in shard_grids():
        cfg = FWConfig(backend="jax_shard", steps=steps, lam=lam, loss=loss, queue="gumbel",
                       epsilon=1.0, delta=1e-6, mesh=(a, b), device=str(dev))
        timings[(a, b)] = _time_per_iter_ms(lambda cfg=cfg: shard_fw(src, y, cfg), steps)
        obs.event("autotune.candidate", backend="jax_shard", loss=loss, candidate=f"{a}x{b}",
                  per_iter_ms=timings[(a, b)], parity=True)
    best = min(timings, key=timings.get)
    default_ms = timings[(1, 1)]
    obs.event("autotune.winner", backend="jax_shard", loss=loss,
              candidate=f"{best[0]}x{best[1]}", per_iter_ms=timings[best],
              speedup=default_ms / max(timings[best], 1e-12))
    stats = data_stats(src.csr) if src.csr is not None else data_stats(src.store)
    _feed_planner("jax_shard", stats, timings[best], loss=loss, platform=plat,
                  modes=("sequential", "vmap"))
    return TuningRecord(content_hash=content_hash, platform=plat, backend="jax_shard",
                        loss=loss, ell_width=None, chunk_steps=None,
                        mesh=best if best != (1, 1) else None,
                        per_iter_default_ms=default_ms, per_iter_tuned_ms=timings[best],
                        pass_parity=True)


def autotune(data, y=None, *, backend: str = "torch_sparse", loss: str = "logistic",
             device: str = "cuda", steps: int = 24, probe_steps: int = 32, lam: float = 20.0,
             force: bool = False) -> TuningRecord:
    """Tune ``backend`` for one dataset on ``device``; persist and replay
    through its store.

    ``data`` may be anything ``solve`` accepts.  For a ``DatasetStore``/
    ``DatasetRef`` the winner lands in ``cache/autotune-*.json`` (guarded by
    the content hash) and warm calls — this function and every solve that
    resolves tuning through ``PreparedDataset`` — replay it without a
    search; ``force=True`` searches again and overwrites.  With telemetry
    on: the ``autotune.candidate``/``autotune.winner`` events and the
    ``autotune.replayed`` counter.
    """
    from repro_torch.core.solvers.prepared import PreparedDataset
    from repro_torch.core.solvers.registry import (BACKEND_ALIASES, as_padded,
                                                   as_shard_source, check_device,
                                                   resolve_data)
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend not in ("torch_sparse", "jax_shard"):
        raise ValueError(f"autotune supports torch_sparse (jax_sparse) and jax_shard, "
                         f"got {backend!r}")
    dev = check_device(device)
    plat = platform_of(dev)
    data, y = resolve_data(data, y)
    store = data if hasattr(data, "autotune_load") else None
    if store is not None and not force:
        rec = store.autotune_load(backend, loss, plat)
        if rec is not None:
            obs.count("autotune.replayed", backend=backend)
            return rec
    if backend == "jax_shard":
        rec = tune_jax_shard(as_shard_source(data), y, loss=loss, steps=steps, lam=lam,
                             content_hash=getattr(store, "content_hash", ""), platform=plat,
                             device=dev)
        if store is not None:
            store.autotune_save(rec)
        return rec
    prepared = as_padded(data, dev)
    if isinstance(prepared, PreparedDataset):
        pcsr, pcsc = prepared.pair
        setup = prepared.setup_for(y, loss)
    else:
        (pcsr, pcsc), setup = prepared, None
    rec = tune_torch_sparse(pcsr, pcsc, y, loss=loss, steps=steps, probe_steps=probe_steps,
                            lam=lam, content_hash=getattr(store, "content_hash", ""),
                            platform=plat, setup=setup)
    if isinstance(prepared, PreparedDataset):
        prepared.set_tuning(rec)
    if store is not None:
        store.autotune_save(rec)
    return rec
