"""The port's sparse layouts against ``repro.core.sparse.formats``: every
array equal element for element (padding convention included), with empty
rows and empty columns in the matrix."""
import numpy as np
import pytest

from repro.core.sparse import formats as jf
from repro_torch.core.sparse import formats as tf


def _matrix(seed=0, n=40, d=70, density=0.08):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, d)) * (rng.random((n, d)) < density)
    x[3] = 0.0          # an empty row
    x[:, [0, 5, 69]] = 0.0  # empty columns, the first and the last among them
    x[:, 7] = rng.uniform(0.1, 1, size=n)  # a dense (heavy) column
    return x


def _eq(jax_arr, torch_arr, msg=""):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_arr.cpu().numpy(), err_msg=msg)


def _host(x):
    h = jf.dense_to_host(x)
    return h, tf.HostCSR(h.indptr, h.indices, h.data, h.shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_formats_equal_jax(seed):
    x = _matrix(seed)
    jh, th = _host(x)
    ours = tf.dense_to_host(x)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(jh, name), getattr(ours, name))
    jc, tc = jh.tocsc(), th.tocsc()
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(jc, name), getattr(tc, name))
    np.testing.assert_array_equal(th.to_dense(), x)
    np.testing.assert_array_equal(tc.to_dense(), x)
    w = np.random.default_rng(seed).normal(size=x.shape[1])
    np.testing.assert_array_equal(jh.matvec(w), th.matvec(w))


def test_coo_to_host_sums_duplicates_like_jax():
    rows = np.array([0, 2, 0, 2, 1, 0])
    cols = np.array([1, 3, 1, 0, 2, 1])
    vals = np.array([0.5, 1.0, 0.25, -1.0, 2.0, 0.125])
    a = jf.coo_to_host(rows, cols, vals, (3, 4))
    b = tf.coo_to_host(rows, cols, vals, (3, 4))
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_to_padded_equal_jax(seed):
    x = _matrix(seed)
    jh, th = _host(x)
    jr, jc = jf.host_to_padded(jh)
    tr, tc = tf.host_to_padded(th, device="cpu")
    for name in ("indices", "values", "nnz"):
        _eq(getattr(jr, name), getattr(tr, name), f"csr.{name}")
        _eq(getattr(jc, name), getattr(tc, name), f"csc.{name}")
    assert tr.shape == jr.shape and tc.shape == jc.shape
    assert str(tr.indices.dtype) == "torch.int32" and str(tr.values.dtype) == "torch.float32"
    dr, dc = tf.dense_to_padded(x, device="cpu")
    for name in ("indices", "values", "nnz"):
        _eq(getattr(jr, name), getattr(dr, name))
        _eq(getattr(jc, name), getattr(dc, name))


@pytest.mark.parametrize("width", [1, 3, 6])
def test_tiered_from_padded_equal_jax(width):
    x = _matrix(4)
    jh, th = _host(x)
    _, jc = jf.host_to_padded(jh)
    _, tc = tf.host_to_padded(th, device="cpu")
    jt = jf.tiered_from_padded(jc, width)
    tt = tf.tiered_from_padded(tc, width)
    for name in ("indices", "values", "nnz", "heavy_slot", "heavy_indices", "heavy_values"):
        _eq(getattr(jt, name), getattr(tt, name), name)
    assert tt.width == jt.width and tt.full_width == jt.full_width
    for j in range(x.shape[1]):
        assert tt.is_heavy(j) == bool(jt.is_heavy(j))
        rows, vals = tt.col_live(j)
        ref_rows, ref_vals = tc.col_live(j)
        np.testing.assert_array_equal(rows.numpy(), ref_rows.numpy())
        np.testing.assert_array_equal(vals.numpy(), ref_vals.numpy())


def test_tiered_width_bounds_refused():
    _, tc = tf.dense_to_padded(_matrix(0), device="cpu")
    with pytest.raises(ValueError):
        tf.tiered_from_padded(tc, 0)
    with pytest.raises(ValueError):
        tf.tiered_from_padded(tc, tc.full_width)
