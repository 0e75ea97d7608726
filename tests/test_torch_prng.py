"""The port's threefry2x32 (``repro_torch.prng``) against ``jax.random``.

Keys, splits and random bits must be equal bit for bit; uniforms too (they
are a bit manipulation of the bits).  Gumbel values pass through two logs
whose implementations differ between XLA and torch by up to 1 ulp, so they
are held to 1 ulp at max(|g|, 1) — the scale at which the noise is added to
a log-weight before the argmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import prng

SEEDS = [0, 1, 2, 7, 42, 12345, 2**31 - 1]
SHAPES = [(1,), (2,), (7,), (3, 5), (1, 217), (218,)]


def _u64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u64(key), prng.PRNGKey(seed).numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_u64(jax.random.split(key, num)),
                                      prng.split(prng.PRNGKey(seed), num).numpy())
    a, b = prng.split2(prng.PRNGKey(seed))
    np.testing.assert_array_equal(_u64(jax.random.split(key)), np.array([a, b]))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_bits_and_uniform_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            _u64(jax.random.bits(key, shape, jnp.uint32)),
            prng.random_bits(prng.PRNGKey(seed), shape).numpy(), err_msg=str(shape))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(key, shape)),
            prng.uniform(prng.PRNGKey(seed), shape).numpy(), err_msg=str(shape))


@pytest.mark.parametrize("seed", range(40))
def test_prng_gumbel_within_one_ulp_of_jax(seed):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    pkey = prng.split(prng.PRNGKey(seed))[1]
    for shape in [(218,), (1, 217)]:
        ref = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
        got = prng.gumbel(pkey, shape).numpy()
        ulp = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
        assert np.all(np.abs(ref - got) <= ulp), (seed, shape)


def test_prng_key_chain_matches_sequential_jax_splits():
    key = jax.random.PRNGKey(3)
    sel_ref = []
    for _ in range(25):
        key, sel = jax.random.split(key)
        sel_ref.append(_u64(sel))
    last, sel = prng.key_chain(prng.PRNGKey(3), 25)
    np.testing.assert_array_equal(np.array(sel), np.array(sel_ref))
    np.testing.assert_array_equal(last.numpy(), _u64(key))
