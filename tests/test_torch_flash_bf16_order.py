"""The bf16 attention forward's order and tile schedule, on the CPU.

``kernels/flash_attention/ref.py`` ``flash_fwd_bf16_plain`` computes the
forward in the ``wgmma`` kernel's order and arithmetic (each consumer
warpgroup of 64 rows visits its key tiles in ascending order; m, l and the
accumulator in float32, in the log2 domain; hidden scores NEG; P rounded to
bf16 before P·V).  It is held against ``repro.models.flash.flash_attention``
and the log-sum-exp of its forward residual (``_flash_fwd``) on the same
bf16-rounded inputs (numpy, seeded), computed by JAX in float32: out within
0.06 + 0.06·|JAX| and 4 bf16 spacings of max(|JAX|, the row's RMS over hdv)
(``chip_smoke.py``'s bf16 bounds), the log-sum-exp within 1e-5 (absolute and
relative).  The cases are causal GQA, a window, cross-attention with Sq ≠ Sk,
a ragged end, MLA's (192, 128) at its native widths, kimi-k2's hd 112
zero-padded to 128 as the wrapper pads it, and hd 256 under a window (the
64-key tiles).

``visited_tiles("forward_bf16")`` walks the kernel's loop bounds
(``f32_tiles.cuh`` ``key_span`` over a block's rows and over each
warpgroup's); over small shapes, causal, window, cross and ragged, it is
checked exhaustively at each of ``BF16_FWD_TILES``: every visible (query,
key) pair falls in exactly one visited tile pair, no visited pair is wholly
hidden, a warpgroup's key tiles come in ascending order, and every key tile a
block loads is computed by one of its warpgroups.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import flash as jflash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref

TOL, SPACINGS, LSE_TOL = 0.06, 4, 1e-5

# (b, sq, sk, h, kv, hd, hdv, causal, window)
CASES = {
    "causal_gqa": (2, 256, 256, 8, 2, 64, 64, True, 0),
    "window": (1, 320, 320, 4, 1, 64, 64, True, 100),
    "cross_sq_ne_sk": (2, 128, 320, 4, 4, 64, 64, False, 0),
    "ragged": (1, 200, 200, 4, 2, 64, 64, True, 0),
    "mla_native": (1, 256, 256, 4, 4, 192, 128, True, 0),
    "hd112_padded": (1, 256, 256, 4, 2, 112, 112, True, 0),
    "hd256_window": (1, 300, 300, 4, 1, 256, 256, True, 130),
}


def _inputs(case, seed=0):
    """q, k, v rounded to bf16 once, as float32 arrays."""
    b, sq, sk, h, kv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float().numpy()
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv))]


def _jax(case, q, k, v):
    """(out, lse) of the JAX package's forward in float32 (one block per
    dimension where the lengths are ragged)."""
    causal, window = case[7:]
    sq, sk = q.shape[1], k.shape[1]
    bq = 64 if sq % 64 == 0 else sq
    bk = 64 if sk % 64 == 0 else sk
    out = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                                 block_q=bq, block_k=bk)
    _, res = jflash._flash_fwd(*map(jnp.asarray, (q, k, v)), causal, window, bq, bk)
    return np.asarray(out), np.asarray(res[4])


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_forward_order_model_matches_jax(name):
    case = CASES[name]
    b, sq, sk, h, kv, hd, hdv, causal, window = case
    q, k, v = _inputs(case)
    want, lse_want = _jax(case, q, k, v)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    width, vwidth = fa_ops.bf16_head_dims(hd, hdv)
    assert (width, vwidth) == ((192, 128) if name == "mla_native" else
                               (128, 128) if name == "hd112_padded" else (hd, hdv))
    # zero-padded as the wrapper pads, at the true scale
    pq, pk = (F.pad(t, (0, width - hd)) for t in (tq, tk))
    pv = F.pad(tv, (0, vwidth - hdv))
    out, lse = ref.flash_fwd_bf16_plain(pq, pk, pv, causal=causal, window=window,
                                        tiles=ref.BF16_FWD_TILES[(width, vwidth)],
                                        scale=1.0 / np.sqrt(hd))
    assert out.dtype == torch.bfloat16 and out.shape == (b, sq, h, vwidth)
    assert not out[..., hdv:].any()          # the padded lanes stay 0
    got = out[..., :hdv].float().numpy()
    diff = np.abs(got - want)
    assert (diff <= TOL + TOL * np.abs(want)).all()
    rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
    spacings = diff / (float(torch.finfo(torch.bfloat16).eps) * np.maximum(np.abs(want), rms))
    assert spacings.max() <= SPACINGS, spacings.max()
    assert lse.shape == lse_want.shape == (b, kv, h // kv, sq)
    np.testing.assert_allclose(lse.numpy(), lse_want, rtol=LSE_TOL, atol=LSE_TOL)


# ---- the tile schedule ---------------------------------------------------------

SIZES = (1, 33, 64, 65, 128, 129, 200, 257)
WINDOWS = (0, 1, 5, 64, 100, 300)
TILE_SETS = sorted(set(ref.BF16_FWD_TILES.values()))


def _visible(sq, sk, causal, window):
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= qpos >= kpos
    if window:
        vis &= qpos - kpos < window
    return vis


@pytest.mark.parametrize("tiles", TILE_SETS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_schedule_covers_each_visible_pair_once(tiles, causal):
    bq, bk = tiles
    for sq, sk, window in itertools.product(SIZES, SIZES, WINDOWS):
        vis = _visible(sq, sk, causal, window)
        count = np.zeros((sq, sk), dtype=np.int64)
        last_key, computed = {}, set()
        for (q0, q1), (k0, k1), wg in ref.visited_tiles("forward_bf16", sq, sk, causal, window,
                                                        tiles=tiles):
            assert 0 <= q0 < q1 <= sq and 0 <= k0 < k1 <= sk
            assert q1 - q0 <= ref.BF16_FWD_WG_ROWS and wg in (0, 1)
            assert vis[q0:q1, k0:k1].any(), (tiles, sq, sk, causal, window, q0, k0)
            count[q0:q1, k0:k1] += 1
            assert last_key.get(q0, -1) < k0          # ascending key tiles a warpgroup
            last_key[q0] = k0
            computed.add((q0 // bq, k0 // bk))
        assert (count[vis] == 1).all(), (tiles, sq, sk, causal, window)
        # the block's loads (key_span over its rows) are all computed
        for q_lo in range(0, sq, bq):
            lo, hi = ref.key_span(q_lo, min(q_lo + bq, sq), bk, sk, causal, window)
            for it in range(lo, hi):
                assert (q_lo // bq, it) in computed, (tiles, sq, sk, causal, window, q_lo, it)
