"""The port's DP selection mechanisms (``repro_torch.core.dp.mechanisms``)
against the JAX package's (``repro.core.dp.mechanisms``).

* ``gumbel_argmax`` and ``laplace_noisy_argmax`` pick JAX's index for the
  same key, for 64 keys (they draw the JAX package's threefry bits).
* ``em_logits`` and ``exponential_mechanism_probs`` are within 1e-6 of JAX's.
* The Gumbel draw follows the exponential mechanism's law: a chi-square test
  over 3,000 keys, its bound the chi-square law's quantile at a
  false-rejection rate of 1e-4, fixed before any draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from repro.core.dp import mechanisms as jm
from repro_torch import prng
from repro_torch.core.dp import mechanisms as tm

KEYS = 64
REJECT_RATE = 1e-4     # the law test's false-rejection rate, chosen before the draws


def _scores(d: int, seed: int) -> np.ndarray:
    return np.abs(np.random.default_rng(seed).normal(0.0, 1.0, size=d)).astype(np.float32)


@pytest.mark.parametrize("d", [7, 300])
def test_gumbel_argmax_takes_jax_index(d):
    logits = _scores(d, 1) * 3.0
    for seed in range(KEYS):
        want = int(jm.gumbel_argmax(jax.random.PRNGKey(seed), jnp.asarray(logits)))
        got = tm.gumbel_argmax(prng.PRNGKey(seed), torch.from_numpy(logits))
        assert int(got) == want, seed


@pytest.mark.parametrize("d", [7, 300])
def test_laplace_noisy_argmax_takes_jax_index(d):
    scores = _scores(d, 2)
    for seed in range(KEYS):
        want = int(jm.laplace_noisy_argmax(jax.random.PRNGKey(seed), jnp.asarray(scores), 0.4))
        got = tm.laplace_noisy_argmax(prng.PRNGKey(seed), torch.from_numpy(scores), 0.4)
        assert int(got) == want, seed


def test_em_logits_and_probs_match_jax():
    scores = _scores(500, 3)
    for eps_step, sens in ((0.1, 0.01), (2.0, 1.0)):
        np.testing.assert_allclose(
            tm.em_logits(torch.from_numpy(scores), eps_step, sens).numpy(),
            np.asarray(jm.em_logits(jnp.asarray(scores), eps_step, sens)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tm.exponential_mechanism_probs(torch.from_numpy(scores), eps_step, sens).numpy(),
            np.asarray(jm.exponential_mechanism_probs(jnp.asarray(scores), eps_step, sens)),
            atol=1e-6)


def test_gumbel_argmax_follows_em_law():
    scores = torch.tensor([0.0, 0.3, 0.6, 1.0, 1.2, 2.0], dtype=torch.float32)
    probs = tm.exponential_mechanism_probs(scores, 1.0, 0.5).double().numpy()
    logits = tm.em_logits(scores, 1.0, 0.5)
    draws = 3000
    counts = np.bincount([int(tm.gumbel_argmax(prng.PRNGKey(1000 + k), logits))
                          for k in range(draws)], minlength=scores.numel())
    expected = draws * probs
    stat = float(((counts - expected) ** 2 / expected).sum())
    assert stat <= chi2.ppf(1.0 - REJECT_RATE, df=scores.numel() - 1), (stat, counts)
