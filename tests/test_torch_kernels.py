"""Plain versions of the port's kernels against the JAX package's kernel ops
(Pallas in interpret mode, as the JAX tests run them on the CPU).

* ``ell_rmatvec``: allclose at rtol/atol 1e-6.
* ``ell_matvec``: against ``ell_matvec_pallas`` (interpret mode, row tiles
  that do not divide N) and JAX's ``PaddedCSR.matvec``, with empty rows, at
  rtol 1e-5 / atol 1e-6 (sums of a row's lanes in another order).
* ``coord_update``: one whole step (lines 16-29) against the JAX scan's step
  body — scalars, the Pallas ``coord_update`` and the queue refresh — for
  every loss, private and non-private: state vectors allclose at 1e-6, the
  g̃ (which carries Δg̃) at 1e-5, priorities and bounds at 1e-6.
* Wrappers route CPU tensors to the plain version and count no launch.
* Masked steps: with ``done`` set, ``coord_update`` writes only the
  sentinels and leaves the state bitwise as it was, the draw returns -1,
  and the step that crosses ``gap_tol`` sets ``done``/``stop_at``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import get_loss as j_get_loss
from repro.core.samplers import bsls_jax as jtl
from repro.core.samplers import group_argmax as jga
from repro.core.sparse import formats as jf
from repro.kernels.coord_update.ops import coord_update as j_coord_update
from repro.kernels.spmv.kernel import ell_matvec_pallas
from repro.kernels.spmv.ops import ell_rmatvec as j_ell_rmatvec
from repro_torch.core.samplers import group_argmax as tga
from repro_torch.core.samplers import two_level as ttl
from repro_torch.core.sparse import formats as tf
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coord_update import coord_update
from repro_torch import prng
from repro_torch.kernels.bsls_draw import two_level_draw
from repro_torch.kernels.spmv import ell_matvec, ell_rmatvec

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 90, 160
    x = rng.uniform(-1, 1, size=(n, d)) * (rng.random((n, d)) < 0.07)
    x[:, 4] = rng.uniform(0.1, 1.0, size=n)        # a column in every row
    x[7] = 0.0                                      # an empty row
    x[:, 11] = 0.0                                  # an empty column
    h = jf.dense_to_host(x)
    jpair = jf.host_to_padded(h)
    tpair = tf.host_to_padded(tf.HostCSR(h.indptr, h.indices, h.data, h.shape), device="cpu")
    y = (rng.random(n) < 0.5).astype(np.float32)
    return x, jpair, tpair, y


def test_ell_rmatvec_plain_matches_jax(problem):
    x, (jr, _), (tr, tc), _ = problem
    before = launch_counts()["ell_rmatvec"]
    for seed in range(3):
        q = np.random.default_rng(seed).normal(size=x.shape[0]).astype(np.float32)
        ref = np.asarray(j_ell_rmatvec(jr, jnp.asarray(q), interpret=True))
        got = ell_rmatvec(tr, torch.from_numpy(q), tc).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, x.T.astype(np.float32) @ q, rtol=1e-4, atol=1e-5)
    assert launch_counts()["ell_rmatvec"] == before


@pytest.mark.parametrize("tile_rows", [8, 32, 256])
def test_ell_matvec_plain_matches_pallas_and_jax(problem, tile_rows):
    x, (jr, _), (tr, _), _ = problem
    assert x.shape[0] % tile_rows or tile_rows > x.shape[0]   # a ragged last tile
    assert int((tr.nnz == 0).sum()) >= 1                         # an empty row
    before = launch_counts()["ell_matvec"]
    for seed in range(3):
        w = np.random.default_rng(seed).normal(size=x.shape[1]).astype(np.float32)
        w[::3] = 0.0                                   # a sparse iterate, as FW's
        got = ell_matvec(tr, torch.from_numpy(w)).numpy()
        pallas = np.asarray(ell_matvec_pallas(jr.indices, jr.values, jnp.asarray(w),
                                              tile_rows=tile_rows, interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jr.matvec(jnp.asarray(w))), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got, tr.matvec(torch.from_numpy(w)).numpy())
        assert got[7] == 0.0
    assert launch_counts()["ell_matvec"] == before


def test_padded_csr_rmatvec_matches_jax(problem):
    x, (jr, _), (tr, _), _ = problem
    q = np.random.default_rng(4).normal(size=x.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tr.rmatvec(torch.from_numpy(q)).numpy(),
                               np.asarray(jr.rmatvec(jnp.asarray(q))), rtol=1e-6, atol=1e-6)


def _state(x, seed, loss):
    """A non-trivial mid-run state (random but in the ranges a run reaches)."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    return dict(
        w=(rng.normal(0, 0.5, d) * (rng.random(d) < 0.2)).astype(np.float32),
        w_m=np.float32(0.37), g_tilde=np.float32(0.8),
        vbar=rng.normal(0, 1, n).astype(np.float32),
        qbar=rng.normal(0, 0.4, n).astype(np.float32),
        alpha=rng.normal(0, 0.05, d).astype(np.float32))


def _jax_step(jpair, y, s, j, t, lam, loss, private, em_scale):
    """The body of ``jax_sparse.fw_scan_chunk``'s step for a fixed j."""
    pcsr, pcsc = jpair
    n = pcsr.shape[0]
    alpha = jnp.asarray(s["alpha"])
    a_j = alpha[j]
    d_tilde = jnp.where(a_j == 0, lam, -jnp.float32(lam) * jnp.sign(a_j))
    gap = s["g_tilde"] - d_tilde * a_j
    eta = jnp.float32(2.0) / (jnp.float32(t) + 2.0)
    w_m = s["w_m"] * (1.0 - eta)
    w = jnp.asarray(s["w"]).at[j].add(eta * d_tilde / w_m)
    g_tilde = s["g_tilde"] * (1.0 - eta) + eta * d_tilde * a_j
    rows, xvals, mask = pcsc.col(j)
    row_idx, row_val = pcsr.indices[rows], pcsr.values[rows]
    obj = j_get_loss(loss)
    vb, qb, al, gd = j_coord_update(
        jnp.asarray(s["vbar"]), jnp.asarray(s["qbar"]), alpha, w, rows, xvals, mask,
        row_idx, row_val, eta=eta, d_tilde=d_tilde, w_m=w_m, inv_n=1.0 / n, loss=loss,
        y_col=None if obj.separable else jnp.asarray(y)[rows], interpret=True)
    flat = row_idx.reshape(-1)
    if private:
        q0 = jtl.tl_init(jnp.abs(alpha) * jnp.float32(em_scale))
        q1 = jtl.tl_update(q0, flat, jnp.abs(al[flat]) * jnp.float32(em_scale))
        queue = (np.asarray(q1.v), np.asarray(q1.c))
    else:
        q0 = jga.ga_init(jnp.abs(alpha))
        q1 = jga.ga_update(q0, flat, jnp.abs(al[flat]))
        queue = (np.asarray(q1.p), np.asarray(q1.bound))
    return dict(w=w, w_m=w_m, g_tilde=g_tilde + gd, vbar=vb, qbar=qb, alpha=al,
                gap=gap, queue=queue)


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_coord_update_plain_matches_jax_step(problem, loss, private):
    x, jpair, (tr, tc), y = problem
    em_scale = 7.5
    before = launch_counts()["coord_update"]
    for case, j in enumerate([4, 0, 11, 37, int(np.argmax((x != 0).sum(0)[12:])) + 12]):
        s = _state(x, 10 * case + 1, loss)
        t, lam = 5.0 + case, 8.0
        ref = _jax_step(jpair, y, s, j, t, lam, loss, private, em_scale)
        st = {k: torch.tensor(v) for k, v in s.items()}
        if private:
            queue = ttl.tl_init(st["alpha"].abs() * em_scale)
        else:
            queue = tga.ga_init(st["alpha"].abs())
        gaps = torch.zeros(3)
        coords = torch.zeros(3, dtype=torch.int32)
        coord_update(torch.tensor([j], dtype=torch.int32), tr, tc, torch.from_numpy(y),
                     st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"], st["alpha"],
                     queue, t=t, lam=lam, inv_n=1.0 / x.shape[0], em_scale=em_scale,
                     loss=loss, gaps=gaps, coords=coords, slot=1)
        if private:
            ttl.tl_rebuild_(queue)
        msg = f"{loss} private={private} j={j}"
        for name in ("w", "w_m", "vbar", "qbar", "alpha"):
            np.testing.assert_allclose(st[name].numpy(), np.asarray(ref[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{msg}: {name}")
        np.testing.assert_allclose(float(st["g_tilde"]), float(ref["g_tilde"]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{msg}: g_tilde")
        np.testing.assert_allclose(float(gaps[1]), float(ref["gap"]), rtol=1e-6, atol=1e-6)
        assert int(coords[1]) == j
        got_queue = (queue.v, queue.c) if private else (queue.p, queue.bound)
        for a, b in zip(got_queue, ref["queue"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6, err_msg=msg)
    assert launch_counts()["coord_update"] == before


def test_coord_update_on_tiered_layout_equals_flat(problem):
    _, _, (tr, tc), y = problem
    tiered = tf.tiered_from_padded(tc, 3)
    outs = []
    for layout in (tc, tiered):
        st = _state(np.zeros(tr.shape), 3, "logistic")
        st = {k: torch.tensor(v) for k, v in st.items()}
        queue = tga.ga_init(st["alpha"].abs())
        gaps, coords = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
        for j in (4, 20, 33):
            coord_update(torch.tensor([j], dtype=torch.int32), tr, layout, None, st["w"],
                         st["w_m"], st["g_tilde"], st["vbar"], st["qbar"], st["alpha"], queue,
                         t=3.0, lam=4.0, inv_n=1.0 / tr.shape[0], em_scale=1.0,
                         loss="logistic", gaps=gaps, coords=coords, slot=0)
        outs.append(st)
    for name in outs[0]:
        assert torch.equal(outs[0][name], outs[1][name]), name


@pytest.mark.parametrize("private", [False, True])
def test_masked_step_freezes_and_sets_the_flags(problem, private):
    _, _, (tr, tc), y = problem
    st = {k: torch.tensor(v) for k, v in _state(np.zeros(tr.shape), 5, "logistic").items()}
    queue = ttl.tl_init(st["alpha"].abs() * 7.5) if private else tga.ga_init(st["alpha"].abs())
    gaps, coords = torch.full((3,), 9.0), torch.full((3,), 9, dtype=torch.int32)
    done, stop_at = torch.tensor(False), torch.tensor(0, dtype=torch.int32)
    kw = dict(lam=8.0, inv_n=1.0 / tr.shape[0], em_scale=7.5, loss="logistic", gaps=gaps,
              coords=coords, done=done, stop_at=stop_at)
    j = torch.tensor([4], dtype=torch.int32)
    args = lambda: (j, tr, tc, None, st["w"], st["w_m"], st["g_tilde"], st["vbar"],
                    st["qbar"], st["alpha"], queue)
    coord_update(*args(), t=3.0, slot=0, gap_tol=-1e30, **kw)
    assert not bool(done) and int(coords[0]) == 4          # gap_tol <= 0 never stops
    coord_update(*args(), t=4.0, slot=1, gap_tol=1e30, **kw)
    assert bool(done) and int(stop_at) == 4 and int(coords[1]) == 4   # applied, then set
    frozen = {k: v.clone() for k, v in st.items()}
    prio = (queue.v if private else queue.p).clone()
    if private:
        ttl.tl_rebuild_(queue)
        c_before = queue.c.clone()
    coord_update(*args(), t=5.0, slot=2, gap_tol=1e30, **kw)
    assert float(gaps[2]) == 0.0 and int(coords[2]) == -1 and int(stop_at) == 4
    for name in st:
        assert torch.equal(st[name], frozen[name]), name
    assert torch.equal(queue.v if private else queue.p, prio)
    if private:
        ttl.tl_rebuild_(queue)                             # no group touched: c unchanged
        assert torch.equal(queue.c, c_before)
        key = prng.PRNGKey(3)
        assert int(two_level_draw(queue.c, queue.v, key, done=done)) == -1
        assert int(two_level_draw(queue.c, queue.v, key, done=torch.tensor(False))) == \
            int(two_level_draw(queue.c, queue.v, key))
