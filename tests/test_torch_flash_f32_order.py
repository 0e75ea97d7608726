"""The float32 attention kernels' order and tile schedule, on the CPU.

``kernels/flash_attention/ref.py`` ``flash_bwd_key_major_plain`` sums the
backward in the float32 kernel's key-major order (dq by key tiles in
ascending order, dk and dv over the G heads and the query tiles from the last
down); it is held against ``jax.vjp`` of ``repro.models.flash.flash_attention``
on the same float32 inputs (numpy, seeded) within 2e-5 × max|JAX| (the card's
float32 bound), at the kernel's tiles and at small ones that make many tile
pairs, unpadded and zero-padded as the wrapper pads.

``visited_tiles`` walks the kernels' loop bounds (``f32_tiles.cuh``
``key_span``, ``query_span``, ``first_key_tile``, copied line for line in
``ref.py``); over small shapes, causal, window, cross and ragged, it is
checked exhaustively at the forward's and the backward's tiles: every visible
(query, key) pair falls in exactly one visited tile pair, no visited pair is
wholly hidden, a row's key tiles come in ascending order, and the key tiles
that visit a query tile are consecutive from ``first_key_tile``, which is what
the backward's dq counters count.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.models import flash

REL = 2e-5

# (b, sq, sk, h, kv, hd, hdv, causal, window, block_q, block_k): tests/test_torch_flash_bwd.py's
CASES = {
    "causal_gqa_blocks": (2, 64, 64, 8, 2, 16, 16, True, 0, 16, 32),
    "window": (1, 96, 96, 4, 1, 16, 16, True, 24, 16, 16),
    "cross_sq_ne_sk": (2, 32, 48, 4, 4, 16, 16, False, 0, 16, 16),
    "hd_ne_hdv": (1, 64, 64, 4, 2, 24, 16, True, 0, 32, 32),
    "one_block": (2, 40, 40, 6, 3, 8, 8, True, 0, 512, 1024),
    "ragged_window_gqa": (1, 90, 90, 8, 2, 16, 16, True, 37, 30, 45),
}
# key tiles × query tiles of the order model: the kernel's (by padded head dim), and
# small ones that make many tile pairs, square and not
SMALL_TILES = [(16, 16), (32, 16), (16, 8)]


def _inputs(case, seed=0):
    b, sq, sk, h, kv, hd, hdv = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hdv)).astype(np.float32),
            rng.normal(size=(b, sq, h, hdv)).astype(np.float32))


def _jax_vjp(case, q, k, v, do):
    causal, window, bq, bk = case[7:]
    _, vjp = jax.vjp(lambda a, b_, c: jflash.flash_attention(
        a, b_, c, causal=causal, window=window, block_q=bq, block_k=bk),
        *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _within(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("tiles", ["kernel"] + SMALL_TILES, ids=str)
@pytest.mark.parametrize("name", sorted(CASES))
def test_key_major_order_model_matches_jax_vjp(name, tiles):
    case = CASES[name]
    b, sq, sk, h, kv, hd, hdv, causal, window, bq, bk = case
    q, k, v, do = _inputs(case)
    want = _jax_vjp(case, q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash._flash_fwd_impl(tq, tk, tv, causal, window, min(bq, sq), min(bk, sk))
    if tiles == "kernel":
        tiles = ref.BWD_TILES[fa_ops.padded_head_dim(hd, hdv)]
    got = ref.flash_bwd_key_major_plain(tq, tk, tv, out, tdo, lse, causal=causal, window=window,
                                        tiles=tiles)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        _within(g, w)


@pytest.mark.parametrize("name", ["hd_ne_hdv", "one_block", "window"])
def test_key_major_order_model_on_the_wrappers_padded_widths(name):
    """The wrapper's float32 route: q, k, v, out and dout zero-padded to one
    width of the table, the true scale, the padded lanes sliced off."""
    case = CASES[name]
    b, sq, sk, h, kv, hd, hdv, causal, window, bq, bk = case
    q, k, v, do = _inputs(case, seed=1)
    want = _jax_vjp(case, q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash._flash_fwd_impl(tq, tk, tv, causal, window, min(bq, sq), min(bk, sk))
    qp, kp, vp, scale, _ = fa_ops.pad_head_dims(tq, tk, tv)
    width = qp.shape[-1]
    assert width in ref.BWD_TILES and width > max(hd, hdv) or width == hd == hdv
    pad = lambda t: torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    dq, dk, dv = ref.flash_bwd_key_major_plain(qp, kp, vp, pad(out), pad(tdo), lse,
                                               causal=causal, window=window,
                                               tiles=ref.BWD_TILES[width], scale=scale)
    for g, w, n in zip((dq, dk, dv), want, (hd, hd, hdv)):
        assert not g[..., n:].any()     # the padded lanes stay 0
        _within(g[..., :n], w)


# ---- the tile schedule ---------------------------------------------------------

SIZES = (1, 33, 64, 65, 128, 129, 200, 257)
WINDOWS = (0, 1, 5, 64, 100, 300)
FWD_TILE_SETS = sorted(set(ref.FWD_TILES.values()))
BWD_TILE_SETS = sorted(set(ref.BWD_TILES.values()))


def _visible(sq, sk, causal, window):
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= qpos >= kpos
    if window:
        vis &= qpos - kpos < window
    return vis


def _check_schedule(kind, tiles, sq, sk, causal, window, groups=1):
    vis = _visible(sq, sk, causal, window)
    count = np.zeros((groups, sq, sk), dtype=np.int64)
    last_key = {}       # (rows, head) -> the last key tile visited, for the order
    for (q0, q1), (k0, k1), step in ref.visited_tiles(kind, sq, sk, causal, window,
                                                      tiles=tiles, groups=groups):
        assert 0 <= q0 < q1 <= sq and 0 <= k0 < k1 <= sk
        assert vis[q0:q1, k0:k1].any(), (kind, tiles, sq, sk, causal, window, q0, k0)
        head = step if kind == "backward" else 0
        count[head, q0:q1, k0:k1] += 1
        if kind == "forward":
            assert last_key.get((q0, q1), -1) < k0     # ascending key tiles a row
            last_key[(q0, q1)] = k0
    for g in range(groups):
        assert (count[g][vis] == 1).all(), (kind, tiles, sq, sk, causal, window)


@pytest.mark.parametrize("tiles", FWD_TILE_SETS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_schedule_covers_each_visible_pair_once(tiles, causal):
    for sq, sk, window in itertools.product(SIZES, SIZES, WINDOWS):
        _check_schedule("forward", tiles, sq, sk, causal, window)


@pytest.mark.parametrize("tiles", BWD_TILE_SETS, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_backward_schedule_covers_each_visible_pair_once(tiles, causal):
    for sq, sk, window in itertools.product(SIZES, SIZES, WINDOWS):
        _check_schedule("backward", tiles, sq, sk, causal, window, groups=2)


@pytest.mark.parametrize("tiles", BWD_TILE_SETS + SMALL_TILES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_backward_dq_counters_count_the_key_tiles_before(tiles, causal):
    """The key tiles that visit a query tile are consecutive from
    ``first_key_tile``, so the counter an item waits on (the key tiles before
    its own that visit the tile) is its index less that first tile."""
    bn, bm = tiles
    for sq, sk, window in itertools.product(SIZES, SIZES, WINDOWS):
        visitors = {}
        for (q0, _), (k0, _), step in ref.visited_tiles("backward", sq, sk, causal, window,
                                                        tiles=tiles):
            visitors.setdefault(q0 // bm, []).append(k0 // bn)
        for t, keys in visitors.items():
            first = ref.first_key_tile(t, bm, bn, window)
            assert keys == list(range(first, first + len(keys))), (tiles, sq, sk, window, t)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 3, 64, 150])
def test_key_span_is_the_plain_versions_bounds_on_whole_blocks(causal, window):
    """On whole blocks inside Sq, ``key_span`` is ``models/flash.py``'s
    ``_bounds`` (the TPU kernel's visibility test), but for a window that ends
    before the first key, where it visits nothing."""
    for sq, sk, bq, bk in itertools.product((64, 256, 512), (64, 256, 512), (32, 64, 128),
                                            (32, 64)):
        nk = sk // bk
        for iq in range(sq // bq):
            lo, hi = ref.key_span(iq * bq, iq * bq + bq, bk, sk, causal, window)
            want = flash._bounds(iq, bq, bk, nk, causal, window)
            if window and iq * bq - window + 1 >= sk:
                assert lo == hi
            else:
                assert (lo, hi) == want
