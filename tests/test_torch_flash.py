"""The port's plain flash attention against the JAX package's.

* ``repro_torch.models.flash.flash_attention`` (the plain version of the
  flash-attention kernel) against ``flash_attention_pallas`` in interpret
  mode and against both packages' materialised ``attention_ref``, on
  ``tests/test_kernels.py``'s sweep (GQA, causal, non-causal, window), with
  the same 64-row blocks: within 2e-5 in float32 and 0.06 in bfloat16, the
  JAX test's own bounds (the two bf16 outputs may round a float32 value to
  neighbouring bf16 values).
* With the default blocks (512 × 1024) against the JAX package's
  ``models/flash.py`` over several q blocks, within 2e-5.
* The kernel op on CPU tensors runs the plain version and counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.flash import flash_attention as j_flash_attention
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import flash_attention as flash_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.flash import flash_attention

CASES = [
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 8, 8, 16, True, 0),
    (2, 128, 4, 1, 64, False, 0),
    (1, 256, 6, 2, 32, True, 64),
    (1, 128, 2, 2, 16, True, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.06)}


def _inputs(b, s, h, kv, hd, jdtype, tdtype, seed=0):
    """The same q, k, v in both packages, rounded to the dtype once (by JAX)."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.normal(size=shape), jdtype)
          for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    ts = [torch.from_numpy(np.array(x, np.float32)).to(tdtype) for x in js]
    return js, ts


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_matches_pallas_kernel(b, s, h, kv, hd, causal, window, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, h, kv, hd, jdtype, tdtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal, window=window, block_q=64, block_k=64)
    assert got.dtype == tdtype and got.shape == tq.shape
    _close(got, want, tol)
    ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(ref, j_attention_ref(jq, jk, jv, causal=causal, window=window), tol)
    _close(got, j_attention_ref(jq, jk, jv, causal=causal, window=window), tol)


def test_default_blocks_match_jax_flash():
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 1024, 4, 2, 32, jnp.float32, torch.float32, 1)
    got = flash_attention(tq, tk, tv, causal=True)
    _close(got, j_flash_attention(jq, jk, jv, causal=True), 2e-5)
    got_w = flash_attention(tq, tk, tv, causal=True, window=300)
    _close(got_w, j_flash_attention(jq, jk, jv, causal=True, window=300), 2e-5)


def test_kernel_op_on_cpu_runs_the_plain_version():
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 128, 4, 2, 32, jnp.float32, torch.float32, 2)
    before = launch_counts()["flash_attention"]
    got = flash_op(tq, tk, tv, causal=True, window=0)
    assert launch_counts()["flash_attention"] == before
    assert torch.equal(got, flash_attention(tq, tk, tv, causal=True))
    _close(got, flash_attention_pallas(jq, jk, jv, causal=True, block_q=64, block_k=64), 2e-5)
