"""The port's attention backward against the JAX package's custom VJP, on the CPU.

``repro_torch.models.flash._flash_bwd`` (the plain version of the card's
backward kernel) against ``jax.vjp`` of ``repro.models.flash.flash_attention``
on the same float32 inputs (numpy, seeded) and the same blocks, within 1e-5
(absolute and relative): causal GQA, a window, non-causal with Sq != Sk,
hd != hdv, a sequence of several blocks and one of a single block.  The
forward's log-sum-exp against JAX's ``_flash_fwd_impl`` within 1e-5, the
output within 1e-6.  The autograd ``Function`` (``kernels/flash_attention``
``FlashAttention``) on CPU tensors against ``torch.autograd`` through the
plain forward within 1e-5, and the op records through it only when a
gradient is wanted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_with_lse)
from repro_torch.models import flash

TOL = 1e-5

# (b, sq, sk, h, kv, hd, hdv, causal, window, block_q, block_k)
CASES = {
    "causal_gqa_blocks": (2, 64, 64, 8, 2, 16, 16, True, 0, 16, 32),
    "window": (1, 96, 96, 4, 1, 16, 16, True, 24, 16, 16),
    "cross_sq_ne_sk": (2, 32, 48, 4, 4, 16, 16, False, 0, 16, 16),
    "hd_ne_hdv": (1, 64, 64, 4, 2, 24, 16, True, 0, 32, 32),
    "one_block": (2, 40, 40, 6, 3, 8, 8, True, 0, 512, 1024),
}


def _inputs(case, seed=0):
    b, sq, sk, h, kv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hdv)).astype(np.float32),
            rng.normal(size=(b, sq, h, hdv)).astype(np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name):
    case = CASES[name]
    causal, window, bq, bk = case[7:]
    q, k, v, do = _inputs(case)
    out_j, vjp = jax.vjp(lambda a, b_, c: jflash.flash_attention(
        a, b_, c, causal=causal, window=window, block_q=bq, block_k=bk), *map(jnp.asarray,
                                                                             (q, k, v)))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    _, lse_j = jflash._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), causal, window, bq, bk)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash._flash_fwd_impl(tq, tk, tv, causal, window, bq, bk)
    assert lse.shape == lse_j.shape and lse.dtype == torch.float32
    _close(out, out_j, 1e-6)
    _close(lse, lse_j)
    dq, dk, dv = flash._flash_bwd(causal, window, bq, bk, (tq, tk, tv, out, lse), tdo)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("name", ["causal_gqa_blocks", "window", "cross_sq_ne_sk",
                                  "hd_ne_hdv"])
def test_autograd_function_matches_autograd_of_plain_forward(name):
    case = CASES[name]
    causal, window = case[7:9]
    q, k, v, do = map(torch.from_numpy, _inputs(case, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = flash.flash_attention(*ref_leaves, causal=causal, window=window)
    want = torch.autograd.grad(ref_out, ref_leaves, do)
    _close(out.detach(), ref_out.detach(), 0.0)
    for g, w in zip(got, want):
        _close(g, w)
    # the op's backward wrapper is the same plain pair on CPU tensors
    o, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window),
                    got):
        _close(g, w, 0.0)


def test_no_gradient_keeps_the_forward_only_call():
    q, k, v, _ = map(torch.from_numpy, _inputs(CASES["causal_gqa_blocks"]))
    assert flash_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q, k, v).grad_fn is not None
    assert fa_ops.flash_attention_bwd.launches == 0     # CPU tensors launch nothing


def test_kernel_route_checks_and_plain_shapes():
    """The kernel route's checks refuse what the kernels do not take (they
    run before any launch, so no card is needed to reach them); on CPU
    tensors the backward wrapper returns the inputs' shapes."""
    q, k, v, do = map(torch.from_numpy, _inputs(CASES["causal_gqa_blocks"]))
    o, lse = flash_attention_with_lse(q, k, v)
    with pytest.raises(ValueError, match="GQA"):
        fa_ops._check(q, k[:, :, :1].expand(-1, -1, 3, -1), v)
    assert fa_ops.padded_head_dim(24, 16) == 32 and fa_ops.padded_head_dim(192, 128) == 256
    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
