"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

* ``train_lm --smoke --device cpu`` (tinyllama-1.1b, 60 steps of 8 × 32 on
  the Markov stream, lr 3e-3) runs, its loss falls by 0.3 nats or more
  (mean of the last 5 logged steps against the first 5; a line every 3
  steps and the last), and a resumed run
  from its checkpoints restores the latest step;
* ``train_lasso --smoke`` (rcv1's smoke twin, ε = 1 and ε = 0) takes the
  coordinates of the port's ``solve`` on the same matrix and config, and
  the JAX package's launcher's coordinates (the engines' contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.paper_lasso import SMOKE as J_SMOKE
from repro.core.fw_jax import SparseJaxConfig, sparse_fw_jax
from repro.core.sparse.formats import host_to_padded as j_host_to_padded
from repro.data.synthetic import make_sparse_classification as j_make
from repro_torch.configs.paper_lasso import SMOKE
from repro_torch.core.solvers import solve
from repro_torch.core.sparse.formats import host_to_padded
from repro_torch.launch import train


def test_train_lm_smoke_on_cpu_loss_falls(tmp_path, capsys):
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "60",
            "--batch", "8", "--seq", "32", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "20", "--out", str(tmp_path / "run.json")]
    result = train.main(args)
    losses = [h["loss"] for h in result["history"]]
    assert len(losses) == 21 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert "state" not in result and (tmp_path / "run.json").exists()
    assert "[train] done" in capsys.readouterr().out
    resumed = train.main(args[:-2] + ["--resume", "--steps", "2"])
    assert resumed["history"][0]["step"] == 61


@pytest.mark.parametrize("epsilon", [1.0, 0.0])
def test_train_lasso_smoke_takes_the_solves_coordinates(epsilon):
    args = train.parser().parse_args(["--arch", "paper-lasso", "--smoke", "--device", "cpu",
                                      "--steps", "60", "--epsilon", str(epsilon)])
    result = train.train_lasso(args)
    ds = SMOKE["rcv1"]
    X, y = train.lasso_problem(ds, 0)
    res = solve(host_to_padded(X, device="cpu"), y, train.lasso_config(args, ds))
    assert result["coords"] == res.coords.tolist()
    assert result["nnz"] == int((res.w != 0).sum()) and 0.0 <= result["accuracy"] <= 1.0
    # the JAX package's launcher solves the same matrix with the same coordinates
    jds = J_SMOKE["rcv1"]
    Xj, yj, _ = j_make(jds.n, jds.d, jds.nnz_per_row, jds.informative,
                       dense_features=jds.dense_features, seed=0)
    np.testing.assert_array_equal(yj, y)
    jres = sparse_fw_jax(*j_host_to_padded(Xj), jnp.asarray(yj, jnp.float32), SparseJaxConfig(
        lam=50.0, steps=60, epsilon=epsilon, delta=1.0 / jds.n ** 2, seed=0,
        queue="two_level" if epsilon > 0 else "group_argmax"))
    assert np.asarray(jres.coords).tolist() == result["coords"]
