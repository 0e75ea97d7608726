"""The summation order of the port's ``ell_rmatvec`` on columns longer than
one segment (``SEGMENT`` entries), on the CPU.

The matrix: ``make_sparse_classification(n=1500, ...)``, whose power-law head
columns hold more than ``SEGMENT`` rows.

* The plain version equals a numpy float32 loop in the stated order (each
  segment in row order from 0, then the segments in order from 0), bit for
  bit, and the old row-order ``index_add_`` on every column of at most
  ``SEGMENT`` entries.
* Against the JAX package's ``ell_rmatvec_pallas`` (interpret mode), whose
  scatter adds in another order on the long columns: per column within
  ``1e-5·Σ|terms| + 1e-7``.
* ``PaddedCSR.rmatvec`` matches the JAX package's ``PaddedCSR.rmatvec``
  within the same bound, and the Alg 1 solve on the padded pair takes the
  JAX package's coordinates (w, gaps, losses within 1e-4: the cross-engine
  contract).
* The segment order (``segments``) is built once per matrix, and its work
  list for the kernel lists each long column's segments in order, from the
  same per-column counts as the flat and tiered column layouts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.core.sparse import formats as jf
from repro.kernels.spmv.kernel import ell_rmatvec_pallas
from repro_torch import FWConfig, solve
from repro_torch.core.sparse import formats as tf
from repro_torch.data.synthetic import make_sparse_classification
from repro_torch.kernels import launch_counts
from repro_torch.kernels.spmv import ell_rmatvec
from repro_torch.kernels.spmv.ref import SEGMENT, build_segments, ell_rmatvec_ref, segments


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=1500, d=3000, nnz_per_row=20, informative=20,
                                         seed=0)
    csc = X.tocsc()
    counts = np.diff(csc.indptr)
    assert (counts > SEGMENT).sum() >= 10 and counts.max() > 4 * SEGMENT
    tpair = tf.host_to_padded(X, device="cpu")
    jpair = jf.host_to_padded(jf.HostCSR(X.indptr, X.indices, X.data, X.shape))
    return X, csc, y, tpair, jpair


def _q(n, seed):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _segmented_loop(csc, q):
    """Xᵀq in the contract's order, one float32 add at a time."""
    vals = csc.data.astype(np.float32)
    out = np.zeros(csc.shape[1], np.float32)
    for j in range(csc.shape[1]):
        lo, hi = csc.indptr[j], csc.indptr[j + 1]
        acc = np.float32(0.0)
        for s in range(lo, hi, SEGMENT):
            part = np.float32(0.0)
            for k in range(s, min(s + SEGMENT, hi)):
                part = np.float32(part + np.float32(vals[k] * q[csc.indices[k]]))
            acc = np.float32(acc + part)
        out[j] = acc
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_plain_equals_ordered_loop(problem, seed):
    _, csc, _, (pcsr, pcsc), _ = problem
    q = _q(pcsr.shape[0], seed)
    before = launch_counts()["ell_rmatvec"]
    got = ell_rmatvec(pcsr, torch.from_numpy(q), pcsc).numpy()
    assert launch_counts()["ell_rmatvec"] == before          # CPU: the plain version
    np.testing.assert_array_equal(got, _segmented_loop(csc, q))


def test_segmented_plain_equals_row_order_on_short_columns(problem):
    _, csc, _, (pcsr, _), _ = problem
    q = torch.from_numpy(_q(pcsr.shape[0], 2))
    got = ell_rmatvec_ref(pcsr.indices, pcsr.values, q, segments(pcsr))
    row_order = torch.zeros(pcsr.shape[1]).index_add_(
        0, pcsr.indices.reshape(-1).long(), (pcsr.values * q[:, None]).reshape(-1))
    short = np.diff(csc.indptr) <= SEGMENT
    assert not short.all()
    np.testing.assert_array_equal(got.numpy()[short], row_order.numpy()[short])


def test_segment_order_is_built_once_per_matrix(problem):
    _, csc, _, (pcsr, _), _ = problem
    order = segments(pcsr)
    assert segments(pcsr) is order                              # kept on the matrix
    fresh = build_segments(pcsr.indices, pcsr.nnz, pcsr.shape[1])
    for a, b in zip(order[:-1], fresh[:-1]):
        assert torch.equal(a, b)
    counts = np.diff(csc.indptr)
    assert order.slot_col.numel() == int(((counts + SEGMENT - 1) // SEGMENT).sum())
    assert order.lanes.numel() == csc.nnz


def test_long_segments_table(problem):
    _, csc, _, (pcsr, pcsc), _ = problem
    counts = np.diff(csc.indptr)
    segs = segments(pcsr)
    want_cols = np.flatnonzero(counts > SEGMENT)
    np.testing.assert_array_equal(segs.long_cols.numpy(), want_cols)
    nseg = (counts[want_cols] + SEGMENT - 1) // SEGMENT
    np.testing.assert_array_equal(segs.first.numpy(), np.concatenate([[0], np.cumsum(nseg)]))
    want = np.concatenate([np.stack([np.full(n, j), np.arange(n)], 1)
                           for j, n in zip(want_cols, nseg)])
    np.testing.assert_array_equal(segs.tasks.numpy(), want)
    assert all(t.dtype == torch.int32 for t in (segs.tasks, segs.long_cols, segs.first))
    # the kernel walks the columns of either layout: their counts are the CSR's
    tiered = tf.tiered_from_padded(pcsc, 40)
    np.testing.assert_array_equal(pcsc.nnz.numpy(), counts)
    np.testing.assert_array_equal(tiered.nnz.numpy(), counts)
    short, _ = tf.host_to_padded(
        tf.dense_to_host(np.eye(3, dtype=np.float32)), device="cpu")
    empty = segments(short)
    assert empty.tasks.shape == (0, 2) and empty.long_cols.numel() == 0
    assert empty.first.tolist() == [0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_plain_matches_pallas(problem, seed):
    X, _, _, (pcsr, pcsc), (jr, _) = problem
    q = _q(pcsr.shape[0], seed)
    got = ell_rmatvec(pcsr, torch.from_numpy(q), pcsc).numpy().astype(np.float64)
    ref = np.asarray(ell_rmatvec_pallas(jr.indices, jr.values, jnp.asarray(q), X.shape[1],
                                        interpret=True)).astype(np.float64)
    absx = tf.HostCSR(X.indptr, X.indices, np.abs(X.data), X.shape)
    scale = absx.tocsc().to_dense().T.astype(np.float32).astype(np.float64) @ np.abs(q)
    err = np.abs(got - ref)
    assert (err <= 1e-5 * scale + 1e-7).all(), float((err - 1e-5 * scale).max())


def test_padded_csr_rmatvec_matches_jax_on_long_columns(problem):
    X, _, _, (pcsr, _), (jr, _) = problem
    q = _q(pcsr.shape[0], 3)
    got = pcsr.rmatvec(torch.from_numpy(q)).numpy().astype(np.float64)
    ref = np.asarray(jr.rmatvec(jnp.asarray(q))).astype(np.float64)
    absx = tf.HostCSR(X.indptr, X.indices, np.abs(X.data), X.shape)
    scale = np.abs(absx.tocsc().to_dense().T.astype(np.float32)) @ np.abs(q)
    assert (np.abs(got - ref) <= 1e-5 * scale + 1e-7).all()


@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_alg1_on_long_columns_takes_jax_coordinates(problem, loss):
    X, _, y, tpair, jpair = problem
    kw = dict(lam=30.0, steps=30, loss=loss, selection="argmax")
    ref = jax_solve(jpair, y, JaxConfig(backend="dense", **kw))
    got = solve(tpair, y, FWConfig(backend="dense", device="cpu", **kw))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    for name in ("w", "gaps", "losses"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, err_msg=name)
