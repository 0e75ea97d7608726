"""The port's DP screening (``screen_every``) against the JAX package's.

* ``screening_rounds``, ``screen_plan``, ``solve_epsilon`` and
  ``check_screen_config`` give JAX's values and refusals.
* Fed the same scores and support, ``Screener.screen`` gives JAX's keep
  masks round by round (private and non-private, the floor, a round that
  keeps all); ``map_coords``/``expand`` give JAX's ids and w.
* ``repack_pair`` gives JAX's arrays, array for array: flat, tiered,
  re-tiered, and a matrix with repeated entries.
* A forced keep-all round leaves the trajectory bit for bit the unscreened
  chunked run's (both backends, private and not; a private screened run
  selects at ``solve_epsilon``, so its counterpart runs at that ε).
* A screened ``solve`` takes JAX's coordinates and fires the same rounds
  with the same survivor counts; so does a store, and ``solve_many`` of a
  screened group equals the per-config solves under ``group.screened``.

Tolerance: the cross-engine contract — coordinates exactly equal, w and the
gaps within atol 1e-4; a tiered layout against JAX's flat one is held to
the same, not to bits (ROADMAP.md §C).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import screening as js
from repro.core.solvers import solve as jax_solve
from repro.core.sparse import formats as jf
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, obs, solve, solve_many
from repro_torch.core.solvers import screening as ts
from repro_torch.core.sparse import formats as tf
from repro_torch.data.synthetic import with_repeated_entries

BASE = dict(lam=30.0, steps=96, chunk_steps=16, seed=3)
# (backend, JAX backend, rule): the queue for Alg 2, the selection for Alg 1
RUNS = [("torch_sparse", "jax_sparse", dict(queue="group_argmax")),
        ("torch_sparse", "jax_sparse", dict(queue="two_level", epsilon=4.0, delta=1e-6)),
        ("dense", "dense", dict(selection="argmax")),
        ("dense", "dense", dict(selection="gumbel", epsilon=4.0, delta=1e-6))]
RUN_IDS = ["alg2_nonprivate", "alg2_private", "alg1_argmax", "alg1_gumbel"]


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    return X, tf.HostCSR(X.indptr, X.indices, X.data, X.shape), y


def _rounds(events) -> list:
    return [(e["attrs"]["round"], e["attrs"]["survivors"], e["attrs"]["repacked"])
            for e in events if e["name"] == "screen.round"]


def _contract(got, ref, msg):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords), err_msg=msg)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0, atol=1e-4,
                               err_msg=msg)
    np.testing.assert_allclose(got.gaps.numpy(), np.asarray(ref.gaps), rtol=0, atol=1e-4,
                               err_msg=msg)


def _bits(got, ref, msg):
    for k in ("coords", "w", "gaps", "losses"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), f"{msg}: {k}"


# ---------------------------------------------------------------------------
# the plan and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,chunk,every", [(96, 16, 1), (96, 16, 2), (96, 16, 5),
                                               (96, 16, 6), (96, 96, 1), (96, 16, 0),
                                               (500, 62, 1), (97, 16, 3)])
def test_screening_rounds_equal_jax(steps, chunk, every):
    assert ts.screening_rounds(steps, chunk, every) == js.screening_rounds(steps, chunk, every)


@pytest.mark.parametrize("kw", [dict(screen_every=2, epsilon=2.0),
                                dict(screen_every=1, epsilon=1.0, steps=500, chunk_steps=62),
                                dict(screen_every=3, screen_eps_frac=0.4, epsilon=0.5),
                                dict(screen_every=0, epsilon=2.0),
                                dict(screen_every=1, chunk_steps=96)])
@pytest.mark.parametrize("private", [True, False])
def test_screen_plan_and_solve_epsilon_equal_jax(kw, private):
    kw = {"steps": 96, "chunk_steps": 16, "delta": 1e-6, **kw}
    got = ts.screen_plan(FWConfig(**kw), private=private)
    want = js.screen_plan(JaxConfig(**kw), private=private)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ts.solve_epsilon(FWConfig(**kw)) == js.solve_epsilon(JaxConfig(**kw))


@pytest.mark.parametrize("kw", [dict(screen_every=-1), dict(screen_every=2, screen_eps_frac=0.0),
                                dict(screen_every=2, screen_eps_frac=1.0),
                                dict(screen_every=2, screen_eps_frac=1.5),
                                dict(screen_every=2, screen_eps_frac=-0.2)])
def test_check_screen_config_refuses_as_jax(kw):
    with pytest.raises(ValueError) as want:
        js.check_screen_config(JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        ts.check_screen_config(FWConfig(**kw))
    assert str(got.value) == str(want.value)
    ts.check_screen_config(FWConfig(screen_every=3))     # on, default fraction: fine


@pytest.mark.parametrize("flag,check,kw,field", [
    ("supports_screening", "check_screening_support", dict(screen_every=2), "screen_every"),
    ("supports_path", "check_path_support", dict(lam=3.0, lambdas=(3.0, 2.0)), "lambdas")])
def test_support_checks_refuse_a_backend_without_the_flag(flag, check, kw, field):
    """Every registered backend of the port sets both flags, so the refusal
    is driven with a copy that clears one, as the JAX package's backends
    without the flag are refused."""
    from repro.core.solvers import registry as jreg
    from repro_torch.core.solvers import registry as treg
    jax_off = dataclasses.replace(jreg.get_backend("jax_sparse"), **{flag: False})
    with pytest.raises(ValueError, match=field):
        getattr(jreg, check)(jax_off, JaxConfig(**kw))
    on = treg.get_backend("torch_sparse")
    assert getattr(on, flag)
    getattr(treg, check)(on, FWConfig(**kw))
    with pytest.raises(ValueError, match=f"'torch_sparse'.*{field}"):
        getattr(treg, check)(dataclasses.replace(on, **{flag: False}), FWConfig(**kw))


# ---------------------------------------------------------------------------
# the keep rule and the index map
# ---------------------------------------------------------------------------


def _scores(kind: str, d: int, rng) -> np.ndarray:
    if kind == "spread":      # a few large, the rest small: a real cut
        return np.abs(rng.standard_normal(d)).astype(np.float32) ** 4
    if kind == "one_peak":    # one score dwarfs the rest: the floor fills the keep set
        s = np.full(d, 1e-6, np.float32)
        s[rng.integers(d)] = 10.0
        return s
    return np.full(d, 0.5, np.float32)   # "flat": every coordinate survives


@pytest.mark.parametrize("kind", ["spread", "one_peak", "flat"])
@pytest.mark.parametrize("private", [True, False])
def test_screener_keeps_what_jax_keeps(kind, private):
    d, n = 600, 150
    kw = dict(steps=96, chunk_steps=16, screen_every=1, seed=7, epsilon=4.0, delta=1e-6)
    args = dict(d=d, n_rows=n, row_width=12, em_scale=3.5, private=private)
    got_s = ts.Screener(FWConfig(**kw), **args)
    want_s = js.Screener(JaxConfig(**kw), **args)
    assert (got_s.noise_b, got_s.min_keep, got_s.sensitivity) == \
        (want_s.noise_b, want_s.min_keep, want_s.sensitivity)
    rng = np.random.default_rng(1)
    fired = 0
    while want_s.due(want_s.rounds_done + 1):
        dc = want_s.d_current
        scores = _scores(kind, dc, rng)
        support = rng.random(dc) < 0.02
        got, want = got_s.screen(scores, support), want_s.screen(scores, support)
        assert (got is None) == (want is None), f"round {want_s.rounds_done}"
        if want is not None:
            np.testing.assert_array_equal(got, want)
            assert got_s.commit(got, repack_seconds=0.0) == \
                want_s.commit(want, repack_seconds=0.0)
            fired += 1
        assert got_s.rounds_done == want_s.rounds_done
        np.testing.assert_array_equal(got_s.sel, want_s.sel)
    assert got_s.rounds_done == 5
    if kind == "flat" and not private:
        assert fired == 0                      # every round kept all: None each time
    else:
        assert fired >= 1
    coords = rng.integers(-1, got_s.d_current, 40).astype(np.int32)
    np.testing.assert_array_equal(got_s.map_coords(torch.from_numpy(coords)).numpy(),
                                  np.asarray(want_s.map_coords(coords)))
    w = rng.standard_normal(got_s.d_current).astype(np.float32)
    np.testing.assert_array_equal(got_s.expand(torch.from_numpy(w)).numpy(),
                                  np.asarray(want_s.expand(w)))


# ---------------------------------------------------------------------------
# the repack
# ---------------------------------------------------------------------------


def _pairs(X, tier=None, repeated=False):
    """The port's and JAX's padded pair of the same matrix (a tiered CSC at
    light width ``tier``)."""
    host = tf.HostCSR(X.indptr, X.indices, X.data, X.shape)
    if repeated:
        rng = np.random.default_rng(3)
        rows = rng.choice(np.flatnonzero(np.diff(X.indptr) > 0), 25, replace=False)
        cols = [int(rng.choice(X.indices[X.indptr[i]:X.indptr[i + 1]])) for i in rows]
        host = with_repeated_entries(host, rows, cols, seed=2)
    jhost = jf.HostCSR(host.indptr, host.indices, host.data, host.shape)
    (p, q), (jp, jq) = tf.host_to_padded(host, "cpu"), jf.host_to_padded(jhost)
    if tier is not None:
        q, jq = tf.tiered_from_padded(q, tier), jf.tiered_from_padded(jq, tier)
    return (p, q), (jp, jq)


def _same_arrays(got, want, msg):
    assert type(got).__name__ == type(want).__name__, msg
    assert tuple(got.shape) == tuple(want.shape), msg
    fields = [f.name for f in dataclasses.fields(got) if f.name != "shape"]
    for name in fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{msg}: {name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("layout", ["flat", "tiered", "retiered", "repeated"])
def test_repack_pair_equals_jax(problem, layout):
    X = problem[0]
    if layout == "retiered":
        # a narrow light tier and a dense matrix: the survivors still exceed it
        Xd, _, _ = make_sparse_classification(n=60, d=30, nnz_per_row=12, informative=5,
                                              seed=2)
        (p, q), (jp, jq) = _pairs(Xd, tier=2)
    else:
        (p, q), (jp, jq) = _pairs(X, tier=4 if layout == "tiered" else None,
                                  repeated=layout == "repeated")
    rng = np.random.default_rng(7)
    keep = rng.random(p.shape[1]) < 0.5
    keep[:3] = True
    got, want = ts.repack_pair(p, q, keep), js.repack_pair(jp, jq, keep)
    for g, w, name in zip(got, want, ("csr", "csc")):
        _same_arrays(g, w, f"{layout} {name}")
    if layout == "retiered":
        assert isinstance(got[1], tf.TieredCSC) and got[1].width == 2
    # Alg 1 on a dense tensor: a column subset; on a pair: both halves
    dense = torch.from_numpy(X.to_dense().astype(np.float32))
    sub = ts.repack_dense(dense, np.arange(X.shape[1]) % 3 == 0)
    assert torch.equal(sub, dense[:, ::3])
    pair = ts.repack_dense((p, q), keep)
    _same_arrays(pair[0], want[0], "repack_dense csr")


@pytest.mark.parametrize("private", [True, False])
def test_repack_carry_equals_jax(problem, private):
    from repro.core.solvers.jax_sparse import fw_carry_init_jit, fw_setup_jit
    from repro_torch import prng
    from repro_torch.core.solvers.torch_sparse import fw_carry_init, fw_setup
    X, host, y = problem
    (p, q), (jp, jq) = _pairs(X)
    em = 2.5 if private else 1.0
    jsetup = fw_setup_jit(jp, np.asarray(y, np.float32), loss="logistic", interpret=True)
    jc = fw_carry_init_jit(X.shape[1], np.float32, *jsetup, em, jax_key(3), private=private)
    setup = fw_setup(p, torch.from_numpy(y.astype(np.float32)), loss="logistic", pcsc=q)
    tc = fw_carry_init(X.shape[1], torch.float32, *setup, em, prng.PRNGKey(3),
                       private=private)
    keep = np.random.default_rng(0).random(X.shape[1]) < 0.3
    want = js.repack_carry(jc, keep, em, private)
    got = ts.repack_carry(tc, keep, em, private)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=0, atol=1e-6)
    # the priorities from the port's own α equal JAX's rule on that α, bit for bit
    prio = got.sampler.v if private else got.sampler.p
    ref = np.abs(got.alpha.numpy()) * np.float32(em)
    np.testing.assert_array_equal(prio.reshape(-1)[: keep.sum()].numpy(), ref)
    assert got.sampler.d == int(keep.sum())
    if private:
        assert not got.sampler.touched.any()
    assert got.key is tc.key and got.done is tc.done and got.vbar is tc.vbar


def jax_key(seed):
    import jax
    return jax.random.PRNGKey(seed)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,jax_backend,rule", RUNS, ids=RUN_IDS)
def test_keep_all_rounds_keep_the_bits(problem, monkeypatch, backend, jax_backend, rule):
    """A round that keeps every coordinate still repacks the pair and
    rebuilds the carry, and must not move a bit of the trajectory."""
    _, host, y = problem
    monkeypatch.setattr(ts.Screener, "screen",
                        lambda self, scores, support: np.ones(scores.shape[0], bool))
    cfg = FWConfig(backend=backend, device="cpu", screen_every=2, **BASE, **rule)
    with obs.session() as tel:
        got = solve(host, y, cfg)
    assert [r[2] for r in _rounds(tel.events)] == [True, True]
    private = rule.get("queue") == "two_level" or rule.get("selection") == "gumbel"
    eps = ts.solve_epsilon(cfg) if private else cfg.epsilon
    assert (eps < cfg.epsilon) == private
    ref = solve(host, y, dataclasses.replace(cfg, screen_every=0, epsilon=eps))
    _bits(got, ref, f"{backend} {rule}")


# Alg 2 on a flat and a tiered CSC; Alg 1 on the dense matrix and on the padded pair
@pytest.mark.parametrize("backend,jax_backend,rule,layout",
                         [(*run, layout) for run in RUNS[:2] for layout in ("flat", "tiered")]
                         + [(*run, layout) for run in RUNS[2:] for layout in ("dense", "pair")],
                         ids=[f"{i}-{layout}" for i in RUN_IDS[:2] for layout in ("flat", "tiered")]
                         + [f"{i}-{layout}" for i in RUN_IDS[2:] for layout in ("dense", "pair")])
def test_screened_solve_takes_jax_coordinates(problem, backend, jax_backend, rule, layout):
    X, host, y = problem
    d0 = X.shape[1]
    jx = jf.host_to_padded(X) if layout == "pair" else X   # Alg 1 reads the same form
    with jobs.session() as jtel:
        ref = jax_solve(jx, y, JaxConfig(backend=jax_backend, screen_every=1, **BASE, **rule))
    data = host
    if layout in ("tiered", "pair"):
        p, q = tf.host_to_padded(host, "cpu")
        data = (p, tf.tiered_from_padded(q, 4) if layout == "tiered" else q)
    with obs.session() as tel:
        got = solve(data, y, FWConfig(backend=backend, device="cpu", screen_every=1, **BASE,
                                      **rule))
    msg = f"{backend} {rule} {layout}"
    _contract(got, ref, msg)
    rounds = _rounds(tel.events)
    assert rounds == _rounds(jtel.events), msg
    assert any(r[2] and r[1] < d0 for r in rounds), msg
    assert got.w.shape == (d0,)
    c = got.coords.numpy()
    assert ((c >= -1) & (c < d0)).all()
    assert set(np.flatnonzero(got.w.numpy()).tolist()) <= set(c[c >= 0].tolist())
    assert float(got.w.abs().sum()) <= BASE["lam"] * (1 + 1e-5)
    assert any(e["name"] == "chunks.respec" for e in tel.events)


def test_screened_store_solve_equals_in_memory(problem, tmp_path, monkeypatch):
    from repro_torch.data.store import DatasetStore
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "datasets"))
    _, host, y = problem
    DatasetStore.from_arrays(str(tmp_path / "store"), host, y, rows_per_shard=64)
    for rule in (dict(queue="two_level", epsilon=4.0), dict(queue="group_argmax")):
        cfg = FWConfig(backend="torch_sparse", device="cpu", screen_every=1, **BASE, **rule)
        with obs.session() as tel:
            got = solve(DatasetStore.open(str(tmp_path / "store")), config=cfg)
        assert any(r[2] for r in _rounds(tel.events)), rule
        _bits(got, solve(host, y, cfg), f"store {rule}")


@pytest.mark.parametrize("plan", ["vmap", "sequential"])
def test_solve_many_screened_group_is_sequential(problem, plan):
    _, host, y = problem
    cfgs = [FWConfig(backend="torch_sparse", device="cpu", queue="two_level", screen_every=2,
                     **{**BASE, "seed": s, "lam": lam}, epsilon=e)
            for s, lam, e in ((0, 30.0, 4.0), (1, 20.0, 8.0), (2, 30.0, 2.0))]
    with obs.session() as tel:
        got = solve_many(host, y, cfgs, plan=plan)
    spans = [e["name"] for e in tel.events if e["ev"] == "span"]
    assert "group.screened" in spans and "group.vmap" not in spans
    for i, (g, c) in enumerate(zip(got, cfgs)):
        _bits(g, solve(host, y, c), f"config {i}")
