"""The port's autotune search against the JAX package's (``solvers/autotune.py``).

* ``candidate_widths`` equals JAX's on the same matrix.
* ``probe_parity`` passes a tiered layout and rejects a corrupted one.
* A tuned store solves bit for bit like the untuned one, for both backends
  and both queues, fixed T and ``gap_tol``.
* A warm open replays the record without a search, ``force=True`` searches
  again, records live under ``torch-cpu`` and a record the JAX package
  wrote for ``cpu`` is never read; the search feeds the planner.

No outcome hangs on which layout wins a wall-clock race: where a winner
matters the timer is stubbed, else the tests assert only what no winner can
change.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core.solvers.autotune import TuningRecord as JaxRecord
from repro.core.solvers.autotune import candidate_widths as jax_candidate_widths
from repro.core.sparse import formats as jf
from repro.data.store import DatasetStore as JaxStore
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.solvers import autotune as at
from repro_torch.core.solvers import planner
from repro_torch.core.sparse.formats import (HostCSR, PaddedCSC, TieredCSC, host_to_padded,
                                             tiered_from_padded)
from repro_torch.data.store import DatasetStore


@pytest.fixture(scope="module")
def problem():
    # power-law column popularity: the padded CSC has a tail to split
    X, y, _ = make_sparse_classification(n=220, d=900, nnz_per_row=12, informative=20,
                                         seed=11)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


@pytest.fixture(scope="module")
def padded(problem):
    return host_to_padded(problem[1], "cpu")


@pytest.fixture()
def store(problem, tmp_path):
    _, host, y = problem
    return DatasetStore.from_arrays(str(tmp_path / "ds"), host, y, rows_per_shard=64)


@pytest.fixture()
def tiered_wins(monkeypatch):
    """A timer under which every tiered candidate is faster than the flat
    layout (the first one wins) and, of the chunk candidates 8 (the default
    at 24 steps), 16 and 24, the chunk of 16 steps wins."""
    monkeypatch.setattr(at, "_time_layout",
                        lambda pcsr, csc, *a, **k: 0.5 if isinstance(csc, TieredCSC) else 1.0)
    calls = []

    def chunk_timer(fn, steps, repeats=3):
        calls.append(1)
        return (3.0, 1.0, 2.0)[(len(calls) - 1) % 3]
    monkeypatch.setattr(at, "_time_per_iter_ms", chunk_timer)


def _bits(res):
    return tuple(t.cpu().numpy().tobytes() for t in (res.w, res.gaps, res.coords))


def test_candidate_widths_equal_jax(problem, padded):
    X, _, _ = problem
    _, pcsc = padded
    cands = at.candidate_widths(pcsc)
    assert cands == jax_candidate_widths(jf.host_to_padded(X)[1])
    assert cands and len(cands) <= at.MAX_WIDTH_CANDIDATES
    assert all(8 <= w < pcsc.full_width for w in cands) and cands == sorted(cands)


@pytest.mark.parametrize("loss", ["logistic", "lad"])
def test_probe_parity_gates_a_corrupted_layout(problem, padded, loss):
    _, _, y = problem
    pcsr, pcsc = padded
    good = tiered_from_padded(pcsc, at.candidate_widths(pcsc)[0])
    assert at.probe_parity(pcsr, pcsc, good, y, loss=loss, steps=8)
    bad = dataclasses.replace(good, values=good.values * 1.5,
                              heavy_values=good.heavy_values * 1.5)
    assert not at.probe_parity(pcsr, pcsc, bad, y, loss=loss, steps=8)


@pytest.mark.parametrize("queue", ["group_argmax", "two_level"])
@pytest.mark.parametrize("backend", ["torch_sparse", "dense"])
@pytest.mark.parametrize("stop", ["fixed", "gap_tol"])
def test_tuned_store_solves_bit_for_bit(store, problem, backend, queue, stop, tiered_wins):
    _, host, y = problem
    cfg = FWConfig(backend=backend, steps=24, lam=15.0, queue=queue, epsilon=1.0,
                   delta=1e-6, seed=3, device="cpu",
                   gap_tol=1e-9 if stop == "gap_tol" else 0.0)
    before = solve(store, config=cfg)
    rec = at.autotune(store, device="cpu", steps=24, probe_steps=8)
    assert rec.pass_parity and rec.ell_width == at.candidate_widths(
        store.prepared("cpu").pcsc)[0] and rec.chunk_steps == 16
    store._prepared.clear()                     # a new PreparedDataset: the record replays
    prep = store.prepared("cpu")
    assert prep.tuning_for("torch_sparse", "logistic") == rec
    after = solve(store, config=cfg)
    assert _bits(before) == _bits(after)
    assert _bits(after) == _bits(solve(host, y, cfg))
    assert after.stop_step_or() == before.stop_step_or()


def test_real_timer_search_keeps_the_bits(store, problem):
    """Unstubbed: whatever layout and chunk win, the solves keep their bits."""
    _, host, y = problem
    cfg = FWConfig(backend="torch_sparse", steps=15, lam=20.0, queue="two_level",
                   epsilon=1.0, delta=1e-6, device="cpu")
    rec = at.autotune(store, device="cpu", steps=6, probe_steps=8)
    assert rec.platform == "torch-cpu" and rec.backend == "torch_sparse"
    assert rec.per_iter_tuned_ms <= rec.per_iter_default_ms and rec.speedup >= 1.0
    store._prepared.clear()
    assert _bits(solve(store, config=cfg)) == _bits(solve(host, y, cfg))


def test_warm_open_replays_and_force_searches(store, monkeypatch, tiered_wins):
    rec = at.autotune(store, device="cpu", steps=24, probe_steps=8)
    assert rec.content_hash == store.content_hash
    assert os.path.exists(os.path.join(
        store.root, "cache", "autotune-torch_sparse-logistic-torch-cpu.json"))
    calls = []
    real = at.tune_torch_sparse
    monkeypatch.setattr(at, "tune_torch_sparse",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    reopened = DatasetStore.open(store.root)
    assert at.autotune(reopened, device="cpu", steps=6, probe_steps=8) == rec
    assert at.autotune(reopened, backend="jax_sparse", device="cpu") == rec
    assert calls == []                                  # replayed, no search
    assert reopened.prepared("cpu").tuning_for("torch_sparse", "logistic") == rec
    again = at.autotune(reopened, device="cpu", steps=24, probe_steps=8, force=True)
    assert calls == [1]
    assert again.ell_width == rec.ell_width and again.chunk_steps == rec.chunk_steps
    # a record for other content never replays
    store.autotune_save(dataclasses.replace(rec, content_hash="0" * 64))
    assert store.autotune_load("torch_sparse", "logistic", "torch-cpu") is None


def test_jax_records_are_never_read(problem, tmp_path, monkeypatch):
    """A record the JAX package wrote for its ``cpu`` platform sits in the
    same store; the port neither replays it nor lets it steer a solve."""
    X, host, y = problem
    root = str(tmp_path / "shared")
    jstore = JaxStore.from_arrays(root, X, y, rows_per_shard=64)
    jrec = JaxRecord(content_hash=jstore.content_hash, platform="cpu", backend="jax_sparse",
                     loss="logistic", ell_width=8, chunk_steps=32)
    jstore.autotune_save(jrec)
    store = DatasetStore.open(root)
    assert store.autotune_load("torch_sparse", "logistic", "torch-cpu") is None
    assert store.prepared("cpu").tuning_for("torch_sparse", "logistic") is None
    calls = []
    real = at.tune_torch_sparse
    monkeypatch.setattr(at, "tune_torch_sparse",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rec = at.autotune(store, device="cpu", steps=6, probe_steps=8)
    assert calls == [1] and rec.platform == "torch-cpu"
    assert JaxStore.open(root).autotune_load("jax_sparse", "logistic", "cpu") == jrec


def test_search_feeds_the_planner(store):
    planner.clear_costbook()
    try:
        rec = at.autotune(store, device="cpu", steps=6, probe_steps=8, force=True)
        got = planner.measured_cost("torch_sparse", "sequential", "torch-cpu",
                                    planner.store_stats(store))
        assert got == pytest.approx(rec.per_iter_tuned_ms / 1e3)
    finally:
        planner.clear_costbook()


def test_in_memory_pair_and_events(problem, padded, tiered_wins):
    from repro_torch import obs
    _, _, y = problem
    with obs.session() as tel:
        rec = at.autotune(padded, y, device="cpu", steps=24, probe_steps=8)
    assert rec.content_hash == "" and rec.ell_width is not None
    events = [e for e in tel.events if e["ev"] == "event"]
    cands = [e for e in events if e["name"] == "autotune.candidate"]
    assert [e["attrs"]["candidate"] for e in cands][0] == "flat"
    assert len(cands) == 1 + len(at.candidate_widths(padded[1]))
    assert sum(e["name"] == "autotune.winner" for e in events) == 1


def test_unported_searches_refuse(store):
    """The sharded engine's search is ported (A12): one process allows only
    the 1×1 grid, whose record persists (no mesh) and replays warm; other
    backends are refused."""
    assert at.shard_grids() == [(1, 1)]
    rec = at.autotune(store, backend="jax_shard", device="cpu", steps=4)
    assert (rec.backend, rec.platform, rec.mesh, rec.ell_width) == (
        "jax_shard", "torch-cpu", None, None)
    assert rec.per_iter_tuned_ms == rec.per_iter_default_ms > 0
    assert at.autotune(store, backend="jax_shard", device="cpu", steps=4) == rec
    with pytest.raises(ValueError, match="torch_sparse"):
        at.autotune(store, backend="dense", device="cpu")
    assert at.tune_jax_sparse is at.tune_torch_sparse


def test_tuning_record_round_trip_and_speedup():
    rec = at.TuningRecord(content_hash="abc", platform="torch-cuda", backend="torch_sparse",
                          loss="logistic", ell_width=128, chunk_steps=32,
                          per_iter_default_ms=2.0, per_iter_tuned_ms=1.0)
    assert at.TuningRecord.from_json(rec.to_json()) == rec
    assert rec.speedup == pytest.approx(2.0)
    assert isinstance(host_to_padded(HostCSR(np.array([0, 1]), np.array([0]),
                                             np.array([1.0]), (1, 1)), "cpu")[1], PaddedCSC)
