"""Repeated entries: a row that lists one column twice.

``HostCSR`` keeps both entries (only ``coo_to_host`` sums them), so such a
matrix reaches the solvers as it is.  The JAX package's step scatter-adds
over column j's lanes: a row that column j lists on m lanes takes all m v̄
terms, one γ from them, m times that γ in q̄, and its row m times in α.  The
port's ``coord_update_ref`` adds in that order (``index_add_``), and the
kernel's owners walk each member row's run of entries once per lane of j
(``ref.scatter_alpha_owners`` states their order in plain PyTorch).

Tolerance: the cross-engine contract — coordinates exactly equal, w and the
gaps within atol 1e-4; the owner order bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers.jax_sparse import jax_sparse_fw
from repro.core.sparse import formats as jf
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.group_argmax import ga_init
from repro_torch.core.samplers.two_level import tl_init
from repro_torch.core.sparse import formats as tf
from repro_torch.data.synthetic import with_repeated_entries
from repro_torch.kernels.coord_update.ops import WARP_OWNER_MAX, owner_table
from repro_torch.kernels.coord_update.ref import (bitwise_rule_mismatches, coord_update_ref,
                                                  same_bits, scatter_alpha_owners,
                                                  scatter_alpha_rows)

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
JAX_TILE = 128   # lanes of the JAX package's coord_update tile (kernel.py DEF_TC)


@pytest.fixture(scope="module")
def repeated_problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    rng = np.random.default_rng(4)
    col_nnz = np.bincount(X.indices, minlength=X.shape[1])
    pairs = []
    for c in np.argsort(col_nnz)[::-1][:6]:                 # the densest columns
        rows = np.flatnonzero(np.diff(X.indptr) > 0)
        holders = [i for i in rows if c in X.indices[X.indptr[i]:X.indptr[i + 1]]]
        pairs += [(i, c) for i in rng.choice(holders, 3, replace=False)]
    for i in rng.choice(X.shape[0], 30, replace=False):    # and any entry of 30 rows
        pairs.append((i, int(rng.choice(X.indices[X.indptr[i]:X.indptr[i + 1]]))))
    rows, cols = zip(*pairs)
    host = with_repeated_entries(tf.HostCSR(X.indptr, X.indices, X.data, X.shape), rows, cols,
                                 seed=5)
    jhost = jf.HostCSR(host.indptr, host.indices, host.data, host.shape)
    return host, jhost, y


def _straddles_a_tile(pcsc) -> bool:
    """Whether a column lists a row on lanes t·128 - 1 and t·128 (the JAX
    kernel would take that row's γ in two tiles)."""
    idx, nnz = pcsc.indices, pcsc.nnz
    for edge in range(JAX_TILE, idx.shape[1], JAX_TILE):
        if bool(((idx[:, edge] == idx[:, edge - 1]) & (nnz > edge)).any()):
            return True
    return False


@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_repeated_entries_solve_like_jax_sparse(repeated_problem, loss, private, layout):
    host, jhost, y = repeated_problem
    tr, tc = tf.host_to_padded(host, device="cpu")
    jr, jc = jf.host_to_padded(jhost)
    owners = owner_table(tc)
    assert int(owners.col_repeats.sum()) >= 6 and int(owners.row_repeats.sum()) >= 20
    assert not _straddles_a_tile(tc)
    if layout == "tiered":
        width = int(np.percentile(tc.nnz.numpy(), 90))
        tc, jc = tf.tiered_from_padded(tc, width), jf.tiered_from_padded(jc, width)
    kw = dict(lam=8.0, steps=30, loss=loss, epsilon=1.0, delta=1e-6,
              queue="two_level" if private else "group_argmax")
    ref = jax_sparse_fw(jr, jc, jnp.asarray(y, jnp.float32),
                        JaxConfig(backend="jax_sparse", **kw))
    got = solve((tr, tc), y, FWConfig(backend="torch_sparse", device="cpu", **kw))
    msg = f"{loss} private={private} {layout}"
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords), err_msg=msg)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), atol=1e-4, err_msg=msg)
    np.testing.assert_allclose(got.gaps.numpy(), np.asarray(ref.gaps), atol=1e-4,
                               err_msg=msg)
    if not private:   # the exact argmax picks dense columns: some list a row twice
        picked = owners.col_repeats[got.coords.long()]
        assert int(picked.sum()) > 0, msg


def test_owner_table_accepts_a_repeated_row():
    # column 1 lists row 0 twice (rows [0, 0, 3]); row 0 lists column 1 twice
    host = tf.HostCSR([0, 3, 4, 4, 6], [1, 2, 1, 0, 0, 1], [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
                      (4, 3))
    pcsr, pcsc = tf.host_to_padded(host, device="cpu")
    assert pcsc.col_live(1)[0].tolist() == [0, 0, 3]
    assert pcsc.col_live(1)[1].tolist() == [1.0, 3.0, 6.0]          # the row's lane order
    owners = owner_table(pcsc)
    assert owners.col_repeats.tolist() == [0, 1, 0]
    assert owners.row_repeats.tolist() == [1, 0, 0, 0]
    assert owners.slots == 0 and owners.heavy.numel() == 0 and owners.lanes == 4
    falling = tf.PaddedCSC(pcsc.indices.clone(), pcsc.values.clone(), pcsc.nnz, pcsc.shape)
    falling.indices[1, :3] = torch.tensor([0, 3, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="fall"):
        owner_table(falling)


def test_a_heavy_column_with_a_repeated_row_gets_no_lane_term_slot():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(WARP_OWNER_MAX + 40, 30)) * \
        (rng.random((WARP_OWNER_MAX + 40, 30)) < 0.1)
    x[:, 4] = 1.0
    x[:, 7] = 2.0
    dense = tf.dense_to_host(x)
    pos = dense.indptr[5] + list(dense.indices[dense.indptr[5]:dense.indptr[6]]).index(7)
    indices = np.insert(dense.indices, pos + 1, 7)            # row 5 lists column 7 twice
    data = np.insert(dense.data, pos + 1, -0.5)
    indptr = dense.indptr + (np.arange(dense.indptr.size) > 5)
    _, pcsc = tf.host_to_padded(tf.HostCSR(indptr, indices, data, x.shape), device="cpu")
    owners = owner_table(pcsc)
    kind = owners.col_info[:, 0]
    assert set(owners.heavy.tolist()) == {4, 7} and owners.slots == 1
    assert int(kind[4]) == 0 and int(kind[7]) == -2 and int(owners.col_repeats[7]) == 1


def test_owner_table_lane_stride_covers_a_column_longer_than_n():
    # 3 rows; column 0 lists row 1 three times: 5 lanes, more than N = 3
    host = tf.HostCSR([0, 1, 4, 5], [0, 0, 0, 0, 0], [1.0, 2.0, 3.0, 4.0, 5.0], (3, 2))
    _, pcsc = tf.host_to_padded(host, device="cpu")
    assert pcsc.col_live(0)[0].tolist() == [0, 1, 1, 1, 2]
    owners = owner_table(pcsc)
    assert owners.lanes == 5 and owners.col_repeats.tolist() == [1, 0]
    assert owners.row_repeats.tolist() == [0, 1, 0]


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("layout", ["flat", "tiered"])
def test_owner_order_with_repeated_entries(repeated_problem, layout, private):
    """The owners' walk (a member row's run once per lane of j) equals
    ``coord_update_ref``'s ``index_add_`` α bit for bit, on columns that
    list a row twice and on columns that do not."""
    host, _, y = repeated_problem
    pcsr, flat = tf.host_to_padded(host, device="cpu")
    pcsc = flat if layout == "flat" else tf.tiered_from_padded(flat, 12)
    owners = owner_table(flat)
    repeated = torch.nonzero(owners.col_repeats).flatten().tolist()
    plain = torch.nonzero((owners.col_repeats == 0) & (flat.nnz > 0)).flatten().tolist()
    n, d = host.shape
    rng = np.random.default_rng(9)
    em = 7.5 if private else 1.0
    for j in repeated[:8] + plain[:3]:
        alpha = torch.from_numpy(rng.normal(0, 0.05, d).astype(np.float32))
        alpha[torch.from_numpy(rng.random(d) < 0.2)] = -0.0
        before = dict(w=torch.zeros(d), w_m=torch.tensor(0.6), g_tilde=torch.tensor(0.3),
                      vbar=torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
                      qbar=torch.from_numpy(rng.normal(0, 0.4, n).astype(np.float32)),
                      alpha=alpha)
        before["queue"] = tl_init(alpha.abs() * em) if private else ga_init(alpha.abs())
        step = dict(t=5.0, lam=8.0, inv_n=1.0 / n, em_scale=em, loss="logistic")
        after = {k: v.clone() for k, v in before.items()}
        after.update(gaps=torch.zeros(1), coords=torch.zeros(1, dtype=torch.int32))
        coord_update_ref(torch.tensor([j], dtype=torch.int32), pcsr, pcsc, y, after["w"],
                         after["w_m"], after["g_tilde"], after["vbar"], after["qbar"],
                         after["alpha"], after["queue"], gaps=after["gaps"],
                         coords=after["coords"], slot=0, **step)
        rows, xv = pcsc.col_live(j)
        rows = rows.long()
        gs = _gammas(j, rows, xv, before, step, y)
        assert same_bits(scatter_alpha_rows(before["alpha"], rows, gs, pcsr), after["alpha"])
        assert same_bits(scatter_alpha_owners(before["alpha"], rows, gs, pcsr, pcsc),
                         after["alpha"]), (layout, j)
        assert bitwise_rule_mismatches(j, pcsr, pcsc, y, before, after, gs, **step) == []


def _gammas(j, rows, xv, st, step, y):
    """γᵢ/N of column j's lanes by ``coord_update_ref``'s operations: a row
    listed on m lanes takes all m v̄ terms, then one γ on each lane."""
    obj = get_loss(step["loss"])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    a_j, lam = st["alpha"][j], f32(step["lam"])
    d_tilde = torch.where(a_j == 0, lam, -lam * torch.sign(a_j))
    eta = f32(2.0) / (f32(step["t"]) + 2.0)
    wm = st["w_m"] * (1.0 - eta)
    vbar = st["vbar"].clone().index_add_(0, rows, eta * d_tilde * xv / wm)
    hm = obj.h(wm * vbar[rows], None if obj.separable else y[rows])
    return (hm - st["qbar"][rows]) * step["inv_n"]
