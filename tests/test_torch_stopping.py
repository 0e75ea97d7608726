"""The port's chunked early stopping against the JAX package's.

* ``gap_tol`` on ``dense`` and ``torch_sparse`` (private and not, every
  loss): the port's ``stop_step``, ``stop_reason`` and coordinates equal the
  JAX package's for the same config, and the stopped run is a bitwise prefix
  of the port's own fixed-T run (sentinels 0.0 / -1 after the stop; ``w``
  equal to a run of exactly ``stop_step`` steps where the run is not
  private).  The tolerance sits midway between two gap values of the JAX
  trace, so a last-ulp difference of a gap cannot move the stop.
* A masked ``torch_sparse`` chunk that stops inside the chunk leaves the
  same carry as JAX's masked ``fw_scan_chunk`` (frozen queue, key stopped
  at the stop step).
* ``max_seconds``: with an injected clock, as ``tests/test_early_stop.py``
  drives the JAX ``drive_chunks``, and on real solves with a zero budget.
* ``drive_chunks`` calls ``advance``/``out_map``/``respec`` as the JAX
  package's does; ``assemble_outputs`` keeps its sentinels and dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.core.solvers import stopping as jstop
from repro.core.solvers.jax_sparse import (em_scale_for, fw_carry_init_jit,
                                           fw_scan_chunk_jit, fw_setup_jit)
from repro.core.solvers.planner import default_chunk as j_default_chunk
from repro.core.sparse import formats as jf
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, interop, prng, solve
from repro_torch.core.solvers import stopping as tstop
from repro_torch.core.solvers.torch_sparse import fw_carry_init, fw_scan_chunk
from repro_torch.core.sparse.formats import HostCSR

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
STEPS = 40


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return X, HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _tol(gaps: np.ndarray, k: int) -> float:
    """A tolerance > 0 midway between two gap values of the trace (or 0 and
    the least positive one) at least 2e-6 apart, whose first crossing lies
    nearest step k.  Private traces are read at DP-drawn coordinates and may
    dip below zero; their first crossing can then come early."""
    pos = np.unique(gaps[gaps > 0]).astype(np.float64)
    cands = [0.5 * pos[0]] if pos[0] > 2e-6 else []
    cands += [0.5 * (a + b) for a, b in zip(pos[:-1], pos[1:]) if b - a > 2e-6]
    first = lambda tol: int(np.argmax(gaps <= np.float32(tol)))
    return min(cands, key=lambda tol: abs(first(tol) - k))


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("backend,jax_backend", [("dense", "dense"),
                                                 ("torch_sparse", "jax_sparse")])
@pytest.mark.parametrize("loss", LOSSES)
def test_gap_tol_matches_jax_and_is_a_prefix(problem, loss, backend, jax_backend, private):
    X, host, y = problem
    kw = dict(lam=8.0, steps=STEPS, loss=loss, queue="two_level" if private else None,
              epsilon=20.0, delta=1e-6, chunk_steps=7)
    jfull = jax_solve(X, y, JaxConfig(backend=jax_backend, **kw))
    tol = _tol(np.asarray(jfull.gaps), STEPS // 3)
    ref = jax_solve(X, y, JaxConfig(backend=jax_backend, gap_tol=tol, **kw))
    cfg = FWConfig(backend=backend, device="cpu", **kw)
    full = solve(host, y, cfg)
    got = solve(host, y, dataclasses.replace(cfg, gap_tol=tol))
    stop = got.stop_step_or()
    msg = f"{backend} {loss} private={private}"
    assert 0 < stop < STEPS, msg
    assert (stop, got.stop_reason) == (int(ref.stop_step), ref.stop_reason) == (
        stop, "gap_tol"), msg
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords), err_msg=msg)
    assert torch.equal(got.coords[:stop], full.coords[:stop]), msg
    assert torch.equal(got.gaps[:stop], full.gaps[:stop]), msg
    assert bool((got.coords[stop:] == -1).all()) and bool((got.gaps[stop:] == 0).all()), msg
    assert got.gaps.dtype == torch.float32 and got.coords.dtype == torch.int32
    if not private:   # (a private run's noise scale depends on T)
        prefix = solve(host, y, dataclasses.replace(cfg, steps=stop))
        assert torch.equal(got.w, prefix.w), msg


@pytest.mark.parametrize("backend", ["dense", "torch_sparse"])
def test_unreachable_or_nonpositive_tolerance_runs_full(problem, backend):
    _, host, y = problem
    for tol in (1e-30, -1.0):
        r = solve(host, y, FWConfig(backend=backend, lam=8.0, steps=10, gap_tol=tol,
                                    device="cpu"))
        assert r.stop_step_or() == 10 and r.stop_reason == "max_steps"
        assert bool((r.coords != -1).all())
    assert not FWConfig(gap_tol=-1.0).early_stopping and FWConfig(max_seconds=1.0).early_stopping


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("backend,jax_backend", [("dense", "dense"),
                                                 ("torch_sparse", "jax_sparse")])
def test_zero_max_seconds_stops_after_two_chunks_like_jax(problem, backend, jax_backend,
                                                         private):
    """The first chunk is never charged; with a zero budget the run stops
    after the second, on both packages."""
    X, host, y = problem
    kw = dict(lam=8.0, steps=200, max_seconds=0.0, chunk_steps=9,
              queue="two_level" if private else None)
    ref = jax_solve(X, y, JaxConfig(backend=jax_backend, **kw))
    got = solve(host, y, FWConfig(backend=backend, device="cpu", **kw))
    assert got.stop_reason == ref.stop_reason == "max_seconds"
    assert got.stop_step_or() == int(ref.stop_step) == 18
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    assert bool(torch.isfinite(got.w).all())


@pytest.mark.parametrize("private", [False, True])
def test_masked_chunk_carry_matches_jax(problem, private):
    X, _, y = problem
    jpcsr, jpcsc = jf.host_to_padded(X)
    n, d = jpcsr.shape
    queue = "two_level" if private else "group_argmax"
    em = em_scale_for(JaxConfig(steps=STEPS, queue=queue, epsilon=20.0), n)
    setup = fw_setup_jit(jpcsr, jnp.asarray(y, jnp.float32), loss="logistic", interpret=True)
    carry0 = fw_carry_init_jit(d, jnp.float32, *setup, em, jax.random.PRNGKey(0),
                               private=private)
    full, (gaps, _) = fw_scan_chunk_jit(jpcsr, jpcsc, carry0, 8.0, em, 0.0, 0, None,
                                        steps=STEPS, loss="logistic", private=private,
                                        fused=True, interpret=True)
    tol = _tol(np.asarray(gaps), 10)
    ref, (rgaps, rcoords) = fw_scan_chunk_jit(
        jpcsr, jpcsc, carry0, 8.0, em, tol, 0, None, steps=STEPS, loss="logistic",
        private=private, fused=True, interpret=True, early_stop=True)
    assert bool(ref.done)

    names = ("indices", "values", "nnz")
    tr = interop.padded_csr({**{k: np.asarray(getattr(jpcsr, k)) for k in names},
                             "shape": jpcsr.shape}, "cpu")
    tc = interop.padded_csc({**{k: np.asarray(getattr(jpcsc, k)) for k in names},
                             "shape": jpcsc.shape}, "cpu")
    carry = fw_carry_init(d, torch.float32, *interop.setup_state(setup, "cpu"), em,
                          prng.PRNGKey(0), private=private)
    carry, (tgaps, tcoords) = fw_scan_chunk(tr, tc, carry, 8.0, em, tol, 0, None,
                                            steps=STEPS, loss="logistic", private=private,
                                            early_stop=True)
    np.testing.assert_array_equal(tcoords.numpy(), np.asarray(rcoords))
    np.testing.assert_allclose(tgaps.numpy(), np.asarray(rgaps), atol=1e-4)
    got = interop.carry_to_numpy(carry)
    assert bool(got["done"]) and int(got["stop_at"]) == int(ref.stop_at)
    np.testing.assert_array_equal(got["key"], np.asarray(ref.key))
    for name in ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)
    for name, value in got["sampler"].items():
        np.testing.assert_allclose(value, np.asarray(getattr(ref.sampler, name)), atol=1e-5,
                                   err_msg=name)


# ---- drive_chunks on its own -----------------------------------------------


class _FakeCarry:
    def __init__(self, done_after=None):
        self.done_after, self.chunks = done_after, 0

    @property
    def done(self):
        return self.done_after is not None and self.chunks >= self.done_after

    @property
    def stop_at(self):
        return 3 + 10 * (self.done_after - 1) if self.done else 0


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def tick(self, seconds):
        self.now += seconds

    def __call__(self):
        return self.now


def _drive(module, *, steps, chunk, max_seconds, tick=None, done_after=None, respec=False):
    """Run ``module.drive_chunks`` over stub chunks; returns (result, trace)."""
    clock, trace = _FakeClock(), []
    zeros = (lambda c: (jnp.zeros(c), jnp.full(c, -1, jnp.int32))) if module is jstop else \
        (lambda c: (torch.zeros(c), torch.full((c,), -1, dtype=torch.int32)))

    def advance(carry, t0, c):
        if tick is not None:
            clock.tick(tick(len([e for e in trace if e[0] == "advance"])))
        trace.append(("advance", t0, c))
        carry.chunks += 1
        return carry, zeros(c)

    def out_map(out, t0):
        trace.append(("out_map", t0))
        return out

    def hook(carry, t0, n_chunks):
        trace.append(("respec", t0, n_chunks))
        return (carry, {}) if n_chunks == 2 else None

    carry, outs, stop, reason = module.drive_chunks(
        advance, _FakeCarry(done_after), steps=steps, chunk=chunk, max_seconds=max_seconds,
        done_of=lambda c: c.done, stop_at_of=lambda c: c.stop_at, clock=clock,
        respec=hook if respec else None, out_map=out_map)
    return (len(outs), stop, reason), trace


@pytest.mark.parametrize("case", [
    dict(steps=40, chunk=10, max_seconds=0.2, tick=lambda i: 0.3 if i == 0 else 0.0),
    dict(steps=500, chunk=10, max_seconds=0.2, tick=lambda i: 0.12 if i > 0 else 0.0),
    dict(steps=45, chunk=10, max_seconds=None, done_after=3, respec=True),
    dict(steps=45, chunk=10, max_seconds=None, respec=True),
    dict(steps=7, chunk=10, max_seconds=0.0),
], ids=["cold-chunk-not-charged", "warm-chunks-charged", "done-with-respec",
        "full-with-respec", "one-short-chunk"])
def test_drive_chunks_follows_the_jax_package(case):
    got = _drive(tstop, **case)
    assert got == _drive(jstop, **case)


def test_compile_heavy_first_chunk_does_not_trip_max_seconds():
    (n_chunks, stop, reason), _ = _drive(tstop, steps=40, chunk=10, max_seconds=0.2,
                                         tick=lambda i: 0.3 if i == 0 else 0.0)
    assert (n_chunks, stop, reason) == (4, 40, "max_steps")


def test_max_seconds_still_enforced_after_warm_chunk():
    (n_chunks, stop, reason), _ = _drive(tstop, steps=500, chunk=10, max_seconds=0.2,
                                         tick=lambda i: 0.12 if i > 0 else 0.0)
    assert reason == "max_seconds" and stop == n_chunks * 10 < 500 and n_chunks >= 2


@pytest.mark.parametrize("parts", [0, 1, 3])
def test_assemble_outputs_sentinels_and_dtypes(parts):
    chunks_t = [(torch.full((4,), 0.5), torch.full((4,), 7, dtype=torch.int32),
                 torch.full((4,), 0.25)) for _ in range(parts)]
    chunks_j = [tuple(jnp.asarray(x.numpy()) for x in c) for c in chunks_t]
    got = tstop.assemble_outputs(chunks_t, 15, (0.0, -1, 0.0))
    ref = jstop.assemble_outputs(chunks_j, 15, (0.0, -1, 0.0))
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.float32]
    for g, r in zip(got, ref):
        assert g.shape == (15,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert bool((got[1][4 * parts:] == -1).all()) and bool((got[0][4 * parts:] == 0).all())


@pytest.mark.parametrize("steps", [1, 7, 8, 63, 64, 500, 2047, 2048, 4000, 10 ** 5])
def test_resolve_chunk_follows_the_jax_package(steps):
    assert tstop.default_chunk(steps) == j_default_chunk(steps)
    for pin in (None, 1, 5, steps, steps + 3, 0):
        assert tstop.resolve_chunk(FWConfig(steps=steps, chunk_steps=pin)) == \
            jstop.resolve_chunk(JaxConfig(steps=steps, chunk_steps=pin))


def test_chunk_geometry_swap():
    geom = tstop.ChunkGeometry(operands=(1,), d=10, pad_row=3)
    geom.swap((2,), 6, pad_row=2, pad_col=4)
    assert (geom.operands, geom.d, geom.pad_row, geom.pad_col, geom.version) == \
        ((2,), 6, 2, 4, 1)
