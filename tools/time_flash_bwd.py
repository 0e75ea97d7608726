"""Check and time the bf16 attention backward kernel on the card, alone.

The quick loop for work on ``kernels/flash_attention/csrc/flash_attention_bwd.cu``
(the key-major ``wgmma`` pass): it builds the port's kernels, holds the
``wgmma``/TMA tile helpers against ``torch.matmul`` (``tiles.py``), then for
each shape runs the forward with its log-sum-exp and the backward, and holds
dq, dk and dv against the plain ``_flash_bwd`` on the card (the bf16 bounds
of ``chip_smoke.py``: 0.06 absolute and relative, and 4 bf16 spacings of
max(|plain|, row RMS, tensor RMS)), checks that ``--repeats`` launches give
the same bits, and times ``--timed`` back-to-back launches with CUDA events
(the wrapper's allocations included, as the training step pays them).  The
first shapes are small (ragged, cross, window, MLA, hd 112); ``--rows`` adds
the five bf16 rows of ``chip_smoke.py``'s ``BWD_ROWS``.  It prints the card's
name and power limit, then one JSON line a shape (the largest error in bf16
spacings of scale, whether the bounds and the bits held, ms a launch).

    PYTHONPATH=src python tools/time_flash_bwd.py [--rows] [--repeats 3] [--timed 5]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_with_lse
from repro_torch.kernels.flash_attention.tiles import tile_products, tile_products_plain
from repro_torch.models.flash import _flash_bwd

# (b, sq, sk, h, kv, hd, hdv, causal, window)
SMALL = [
    (2, 256, 256, 8, 2, 64, 64, True, 0),
    (2, 1024, 1024, 8, 2, 64, 64, True, 0),
    (1, 200, 328, 4, 4, 64, 64, False, 0),
    (1, 200, 200, 4, 4, 32, 32, True, 0),
    (1, 256, 384, 4, 2, 128, 128, False, 0),
    (1, 256, 256, 4, 2, 112, 112, True, 0),
    (1, 256, 256, 4, 4, 192, 128, True, 0),
    (1, 512, 512, 4, 1, 256, 256, True, 128),
]
# chip_smoke.py's bf16 BWD_ROWS: tinyllama, deepseek-v2's MLA, kimi-k2, recurrentgemma, seamless
ROWS = [
    (8, 2048, 2048, 32, 4, 64, 64, True, 0),
    (1, 2048, 2048, 128, 128, 192, 128, True, 0),
    (1, 1024, 1024, 64, 8, 112, 112, True, 0),
    (1, 4096, 4096, 10, 1, 256, 256, True, 2048),
    (4, 1024, 1536, 16, 16, 64, 64, False, 0),
]


def ulps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(largest |d| in bf16 spacings of scale, both bounds held)."""
    want = want.float()
    diff = (got.float() - want).abs()
    scale = torch.maximum(torch.maximum(want.abs(), want.pow(2).mean(-1, keepdim=True).sqrt()),
                          want.pow(2).mean().sqrt())
    spacings = float((diff / (torch.finfo(torch.bfloat16).eps * scale)).max())
    return spacings, bool((diff <= 0.06 + 0.06 * want.abs()).all()) and spacings <= 4


def case(shape, repeats: int, timed: int) -> dict:
    b, sq, sk, h, kv, hd, hdv, causal, window = shape
    gen = torch.Generator("cuda").manual_seed(sq + sk + hd)
    q, k, v, do = (torch.randn(dims, generator=gen, device="cuda").to(torch.bfloat16)
                   for dims in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv), (b, sq, h, hdv)))
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    bwd = lambda: flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    got = bwd()
    block_q = min(512, sq) if sq % min(512, sq) == 0 else sq
    block_k = next(bk for bk in (1024, 512, 256, sk) if sk % bk == 0)
    want = _flash_bwd(causal, window, block_q, block_k, (q, k, v, out, lse), do)
    errs = {name: ulps(g, w) for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    del want
    same = all(torch.equal(a, c) for _ in range(repeats - 1) for a, c in zip(got, bwd()))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(timed):
        bwd()
    end.record()
    end.synchronize()
    return dict(shape=list(shape), max_bf16_spacings={n: e[0] for n, e in errs.items()},
                bounds_held=all(e[1] for e in errs.values()), bits_equal=same,
                repeats=repeats, ms=start.elapsed_time(end) / timed)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", action="store_true", help="also the five bf16 rows of chip_smoke")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--timed", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_bwd: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _lib.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator("cuda").manual_seed(64)
    q, k, dout = (torch.randn(dims, generator=gen, device="cuda").to(torch.bfloat16)
                  for dims in ((64, 64), (256, 64), (64, 64)))
    s, y, z = tile_products(q, k, dout)
    s_ref = tile_products_plain(q, k, dout)[0]
    _, y_ref, z_ref = tile_products_plain(q, k, dout, s)
    print(json.dumps({"tile_helpers_max_rel_err": {
        n: float((g - w).abs().max() / w.abs().max())
        for n, g, w in (("s", s, s_ref), ("y", y, y_ref), ("z", z, z_ref))}}), flush=True)
    for shape in SMALL + (ROWS if args.rows else []):
        print(json.dumps(case(shape, args.repeats, args.timed)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
