"""The port's main path on the ``TieredCSC`` layout against the JAX package's
``jax_sparse`` scan on the same tiered layout, every loss, private and
non-private: coordinates exactly equal, w and gaps within atol 1e-4 (the
cross-engine contract).  The port's tiered run must also take the flat
run's coordinates exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers.jax_sparse import jax_sparse_fw
from repro.core.sparse import formats as jf
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, solve
from repro_torch.core.sparse import formats as tf

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]


@pytest.fixture(scope="module")
def tiered_problem():
    X, y, _ = make_sparse_classification(n=150, d=600, nnz_per_row=10, informative=15,
                                         seed=11)
    jr, jc = jf.host_to_padded(X)
    host = tf.HostCSR(X.indptr, X.indices, X.data, X.shape)
    tr, tc = tf.host_to_padded(host, device="cpu")
    # the 90th-percentile column count: a real heavy tier of the densest columns
    width = int(np.percentile(np.asarray(jc.nnz), 90))
    assert 1 <= width < tc.full_width
    return (jr, jf.tiered_from_padded(jc, width)), (tr, tf.tiered_from_padded(tc, width)), \
        (tr, tc), y


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_torch_sparse_tiered_matches_jax_sparse_tiered(tiered_problem, loss, private):
    (jr, jt), (tr, tt), flat, y = tiered_problem
    assert int((tt.nnz > tt.width).sum()) > 0
    kw = dict(lam=8.0, steps=30, loss=loss, epsilon=1.0, delta=1e-6,
              queue="two_level" if private else "group_argmax")
    ref = jax_sparse_fw(jr, jt, jnp.asarray(y, jnp.float32),
                        JaxConfig(backend="jax_sparse", **kw))
    cfg = FWConfig(backend="torch_sparse", device="cpu", **kw)
    got = solve((tr, tt), y, cfg)
    msg = f"{loss} private={private}"
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords), err_msg=msg)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), atol=1e-4, err_msg=msg)
    np.testing.assert_allclose(got.gaps.numpy(), np.asarray(ref.gaps), atol=1e-4,
                               err_msg=msg)
    flat_run = solve(flat, y, dataclasses.replace(cfg))
    assert torch.equal(flat_run.coords, got.coords), msg
