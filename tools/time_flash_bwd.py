"""Check and time the attention kernels on the card, alone: the bf16 backward,
(``--fwd``) the bf16 forward, or (``--f32``) the float32 forward and backward.

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

``--f32`` is the quick loop for the float32 routes
(``csrc/flash_attention.cu`` and the CUDA-core route of
``flash_attention_bwd.cu``): it prints the compiler's registers and spills of
their kernels, then for each shape (small ragged, GQA, window, cross and hd
16/32/112/128/256 shapes, then tinyllama's forward at 4 × 2,048 and backward
at 8 × 2,048 and ``chip_smoke.py``'s float32 cross and window rows) runs the
forward with its log-sum-exp and the backward, holds out against the plain
forward (2e-5, absolute and relative: ``chip_smoke.py``'s ``FLASH_TOL``), out
bit for bit against the forward without the log-sum-exp, and dq, dk, dv
against the plain ``_flash_bwd`` (max |d| <= 2e-5 max |plain|:
``BWD_F32_REL``), checks that ``--repeats`` launches of each give the same
bits, and times ``--timed`` launches of each with CUDA events, beside SDPA in
float32 (forward, and fwd+bwd less fwd) at the large shapes.

    PYTHONPATH=src python tools/time_flash_bwd.py --f32 [--repeats 3] [--timed 5]

``--fwd`` is the quick loop for ``csrc/flash_attention_wgmma.cu`` (the
``wgmma``/TMA forward): it prints the compiler's registers, spills and notes
of the forward's kernels, then for each shape runs the forward with and
without its log-sum-exp and holds out against the plain version
(``models/flash.py``) within ``chip_smoke.py``'s bf16 bounds (0.06 absolute
and relative, and 4 bf16 spacings of max(|plain|, the row's RMS over hdv)),
the log-sum-exp against the plain one (1e-5, absolute and relative), out bit
for bit with and without the log-sum-exp and over ``--repeats`` launches.
The first shapes are small (ragged, cross, window, GQA, hd 16 to 256, MLA's
(192, 128), hd 112); ``--rows`` adds ``chip_smoke.py``'s bf16 rows 5 and
5c-5f (tinyllama, deepseek-v2's MLA, kimi-k2, recurrentgemma's window,
seamless' cross), timed over ``--timed`` launches (the wrapper's padding and
allocations included, as the model pays them) beside SDPA and the operations
bound.  ``--time-only`` times those rows without the checks, through the
public entry points only, so that the same script times an older checkout in
the same call: unpack ``git archive <commit>`` under ``build/`` and run it
with ``PYTHONPATH=build/<dir>/src``.

    PYTHONPATH=src python tools/time_flash_bwd.py --fwd [--rows | --time-only] [--timed 20]

Every time is device ms a launch over back-to-back launches, with CUDA events
behind a sleep kernel that holds the stream while the host enqueues them
(``chip_smoke.py``'s ``device_ms``).

``--smem`` builds and runs ``tools/smem_probe.cu``: the SM cycles a warp's
shared-memory load takes by width and by the number of distinct addresses it
touches (the cost model behind the float32 kernels' thread tiles).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_with_lse)
from repro_torch.kernels.flash_attention.tiles import tile_products, tile_products_plain
from repro_torch.models.flash import _flash_bwd, _flash_fwd_impl
from repro_torch.models.flash import flash_attention as flash_attention_plain

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

# --fwd: the same tuples
FWD_SMALL = [
    (2, 256, 256, 8, 2, 64, 64, True, 0),        # causal GQA
    (1, 200, 200, 4, 2, 64, 64, True, 0),        # a ragged last tile
    (1, 200, 328, 4, 4, 64, 64, False, 0),       # ragged non-causal cross
    (3, 32, 32, 8, 2, 64, 64, True, 0),          # fewer rows than one tile
    (2, 50, 50, 16, 2, 16, 16, True, 0),         # hd 16 (padded to 64), G = 8
    (1, 70, 70, 8, 1, 32, 32, False, 0),         # hd 32, non-causal, ragged
    (1, 300, 300, 4, 4, 64, 64, True, 100),      # window
    (1, 130, 130, 16, 2, 128, 128, False, 0),    # hd 128, non-causal, ragged
    (2, 96, 96, 4, 2, 128, 128, True, 0),
    (1, 256, 256, 4, 2, 112, 112, True, 0),      # kimi-k2's 112, padded to 128
    (1, 256, 256, 4, 4, 192, 128, True, 0),      # MLA's (192, 128), native
    (1, 130, 130, 8, 2, 18, 18, True, 0),        # hd 18 (padded to 64)
    (1, 160, 160, 2, 1, 256, 256, True, 0),      # hd 256
    (1, 20, 20, 4, 1, 256, 256, True, 0),        # hd 256, fewer rows than one tile
    (1, 512, 512, 4, 1, 256, 256, True, 128),    # hd 256 window, MQA
    (2, 1024, 1024, 8, 2, 64, 64, True, 0),      # many key tiles
]
# chip_smoke.py's bf16 rows: 5 tinyllama, 5c deepseek-v2's MLA, 5d kimi-k2, 5e
# recurrentgemma's window, 5f seamless' cross
FWD_ROWS = {
    "5": (4, 2048, 2048, 32, 4, 64, 64, True, 0),
    "5c": (1, 2048, 2048, 128, 128, 192, 128, True, 0),
    "5d": (1, 1024, 1024, 64, 8, 112, 112, True, 0),
    "5e": (2, 4096, 4096, 10, 1, 256, 256, True, 2048),
    "5f": (4, 1024, 1536, 16, 16, 64, 64, False, 0),
}

# --f32: (b, sq, sk, h, kv, hd, causal, window)
F32_SMALL = [
    (2, 256, 256, 8, 2, 64, True, 0),        # GQA
    (1, 200, 200, 4, 4, 32, True, 0),        # ragged
    (2, 50, 50, 16, 2, 16, True, 0),         # hd 16, G = 8, fewer rows than a tile
    (1, 256, 384, 4, 2, 128, False, 0),      # cross, S_q != S_k
    (1, 200, 328, 4, 4, 64, False, 0),       # ragged cross
    (1, 300, 300, 4, 4, 64, True, 100),      # window, ragged
    (1, 512, 512, 4, 1, 256, True, 128),     # window, MQA, hd 256
    (1, 130, 130, 16, 2, 112, False, 0),     # hd 112, padded to 128
    (2, 1024, 1024, 8, 2, 64, True, 0),      # many key tiles (the ordered dq adds)
]
# tinyllama's forward (B = 4) and training (B = 8) shapes, and chip_smoke.py's float32
# backward rows at seamless' cross and recurrentgemma's window shapes
F32_ROWS = [
    (4, 2048, 2048, 32, 4, 64, True, 0),
    (8, 2048, 2048, 32, 4, 64, True, 0),
    (4, 1024, 1536, 16, 16, 64, False, 0),
    (1, 4096, 4096, 10, 1, 256, True, 2048),
]
F32_TOL = 2e-5          # chip_smoke.py's FLASH_TOL[float32] and BWD_F32_REL
F32_OPS_PER_S = 67e12   # float32 on the CUDA cores, H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores, H100 SXM
TOL, SPACINGS, LSE_TOL = 0.06, 4, 1e-5  # chip_smoke.py's bf16 bounds; the lse's


def attention_ops(b, sq, sk, h, hd, causal, window) -> float:
    """chip_smoke.py's: flops of the scores and P·V over the keys each query sees."""
    qpos = torch.arange(sq, dtype=torch.float64)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros(sq, dtype=torch.float64)
    hi = (qpos + 1).clamp(max=sk) if causal else torch.full((sq,), float(sk), dtype=torch.float64)
    return 4.0 * b * h * hd * float((hi - lo).clamp(min=0).sum())


def events_ms(fn, n: int) -> float:
    """Device ms a call of ``fn`` over ``n`` back-to-back calls: a sleep kernel
    holds the stream while the host enqueues them, so the events time the
    kernels, not the host."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def f32_case(shape, repeats: int, timed: int, sdpa: bool) -> dict:
    """The float32 forward and backward at one shape against the plain versions."""
    b, sq, sk, h, kv, hd, causal, window = shape
    gen = torch.Generator("cuda").manual_seed(sq + sk + hd + h)
    q, k, v, do = (torch.randn(dims, generator=gen, device="cuda")
                   for dims in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd)))
    fwd = lambda: flash_attention(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    bq = min(512, sq) if sq % min(512, sq) == 0 else sq
    bk = next(x for x in (1024, 512, 256, sk) if sk % x == 0)
    want = flash_attention_plain(q, k, v, causal=causal, window=window, block_q=bq, block_k=bk)
    fwd_err = float((out - want).abs().max())
    fwd_ok = bool(((out - want).abs() <= F32_TOL + F32_TOL * want.abs()).all())
    lse_bits = torch.equal(out, fwd())
    del want
    bwd = lambda: flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    got = bwd()
    want = _flash_bwd(causal, window, bq, bk, (q, k, v, out, lse), do)
    rel = {n: float((g - w).abs().max() / w.abs().max())
           for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del want
    same = (all(torch.equal(out, fwd()) for _ in range(repeats - 1))
            and all(torch.equal(a, c) for _ in range(repeats - 1) for a, c in zip(got, bwd())))
    ops = attention_ops(b, sq, sk, h, hd, causal, window)
    row = dict(shape=list(shape), fwd_max_abs_err=fwd_err, fwd_bound_held=fwd_ok,
               out_bits_with_lse=lse_bits, bwd_max_rel_err=rel,
               bwd_bound_held=all(r <= F32_TOL for r in rel.values()), bits_equal=same,
               repeats=repeats, fwd_ms=events_ms(fwd, timed), bwd_ms=events_ms(bwd, timed),
               fwd_bound_ms=ops / F32_OPS_PER_S * 1e3,
               bwd_bound_ms=2.5 * ops / F32_OPS_PER_S * 1e3)
    if sdpa:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if window:
            d = torch.arange(sq, device="cuda")[:, None] - torch.arange(sk, device="cuda")[None, :]
            mask = (d >= 0) & (d < window)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window, enable_gqa=h != kv)
        lib_fb = lambda: torch.autograd.grad(lib(), (qt, kt, vt), dot)
        with torch.no_grad():
            row["sdpa_fwd_ms"] = events_ms(lib, timed)
        row["sdpa_bwd_ms"] = events_ms(lib_fb, timed) - events_ms(lib, timed)
    return row


def ptxas_lines(log: str, entries: tuple) -> list:
    """The compiler's register, spill and wgmma lines of the kernels whose
    mangled names hold one of ``entries``."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(e in line for e in entries)
            if keep:
                out.append(line.split("'")[1] if "'" in line else line)
        elif keep and ("registers" in line or "spill" in line or "wgmma" in line.lower()):
            out.append(line.strip())
    return out


def smem_probe() -> None:
    """Build ``tools/smem_probe.cu`` into the build directory and print its lines."""
    src = Path(__file__).with_name("smem_probe.cu")
    exe = _lib.BUILD_ROOT / "smem_probe"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_lib.nvcc(), *_lib.ARCH, "-O3", "-o", str(exe), str(src)], check=True,
                   timeout=300)
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    print(run.stdout.strip(), flush=True)
    if run.returncode:
        raise SystemExit(f"smem_probe failed: {run.stderr}")


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
    return dict(shape=list(shape), max_bf16_spacings={n: e[0] for n, e in errs.items()},
                bounds_held=all(e[1] for e in errs.values()), bits_equal=same,
                repeats=repeats, ms=events_ms(bwd, timed))


def fwd_inputs(shape):
    b, sq, sk, h, kv, hd, hdv, causal, window = shape
    gen = torch.Generator("cuda").manual_seed(sq + sk + hd + hdv + h)
    return [torch.randn(dims, generator=gen, device="cuda").to(torch.bfloat16)
            for dims in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv))]


def fwd_check(shape, repeats: int) -> dict:
    """The forward at one shape against the plain version, bits over launches."""
    b, sq, sk, h, kv, hd, hdv, causal, window = shape
    q, k, v = fwd_inputs(shape)
    fwd = lambda: flash_attention(q, k, v, causal=causal, window=window)
    got = fwd()
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    bq = next(x for x in (512, 256, 128, sq) if sq % x == 0)
    bk = next(x for x in (1024, 512, 256, sk) if sk % x == 0)
    want, lse_want = _flash_fwd_impl(q, k, v, causal, window, bq, bk)
    want = want.float()
    diff = (got.float() - want).abs()
    scale = torch.maximum(want.abs(), want.pow(2).mean(-1, keepdim=True).sqrt())
    spacings = float((diff / (torch.finfo(torch.bfloat16).eps * scale)).max())
    lse_err = float(((lse - lse_want).abs() / (1 + lse_want.abs())).max())
    row = dict(shape=list(shape), max_abs_err=float(diff.max()), max_bf16_spacings=spacings,
               bounds_held=bool((diff <= TOL + TOL * want.abs()).all()) and spacings <= SPACINGS
               and bool(torch.isfinite(got).all()),
               lse_max_err=lse_err,
               lse_held=bool(((lse - lse_want).abs() <= LSE_TOL + LSE_TOL * lse_want.abs()).all()),
               bits_with_lse=torch.equal(got, out),
               bits_equal=all(torch.equal(got, fwd()) for _ in range(repeats - 1)),
               repeats=repeats)
    return row


def fwd_timed(name: str, shape, n: int, only: bool) -> dict:
    """A row's ms beside SDPA's and the bound of the unpadded work."""
    b, sq, sk, h, kv, hd, hdv, causal, window = shape
    q, k, v = fwd_inputs(shape)
    fwd = lambda: flash_attention(q, k, v, causal=causal, window=window)
    row = dict(row=name, shape=list(shape))
    if not only:
        row.update(fwd_check(shape, 2))
    ms = events_ms(fwd, n)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if window:
        d = torch.arange(sq, device="cuda")[:, None] - torch.arange(sk, device="cuda")[None, :]
        mask = (d >= 0) & (d < window)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not window, enable_gqa=h != kv)
    ops = attention_ops(b, sq, sk, h, (hd + hdv) / 2, causal, window)
    row.update(ms=ms, sdpa_ms=events_ms(sdpa, n), bound_ms=ops / BF16_OPS_PER_S * 1e3,
               tflop_per_s=ops / ms / 1e9)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", action="store_true",
                    help="also chip_smoke's five bf16 rows (the backward's; --fwd: rows 5, 5c-5f)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--timed", type=int, default=None, help="launches timed (5; --fwd 20)")
    ap.add_argument("--fwd", action="store_true",
                    help="the bf16 forward instead of the bf16 backward")
    ap.add_argument("--time-only", action="store_true",
                    help="only time the bf16 forward's rows (public entry points only)")
    ap.add_argument("--f32", action="store_true",
                    help="the float32 forward and backward instead of the bf16 backward")
    ap.add_argument("--smem", action="store_true",
                    help="only the shared-memory load costs (tools/smem_probe.cu)")
    args = ap.parse_args()
    fwd = args.fwd or args.time_only
    timed = args.timed or (20 if fwd else 5)
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_bwd: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.smem:
        smem_probe()
        return
    t0 = time.perf_counter()
    _lib.library()
    print(json.dumps({"build_s": time.perf_counter() - t0, "source": _lib.__file__}), flush=True)
    if fwd:
        if not args.time_only:
            for line in ptxas_lines(_lib.build()[1]["log"], ("flash_fwd_wgmma",)):
                print(line, flush=True)
            for shape in FWD_SMALL:
                print(json.dumps(fwd_check(shape, args.repeats)), flush=True)
                torch.cuda.empty_cache()
        if args.rows or args.time_only:
            for name, shape in FWD_ROWS.items():
                print(json.dumps(fwd_timed(name, shape, timed, args.time_only)), flush=True)
                torch.cuda.empty_cache()
        return
    if args.f32:
        for line in ptxas_lines(_lib.build()[1]["log"], ("flash_fwd_kernel", "2cc10bwd_kernel")):
            print(line, flush=True)
        for shape in F32_SMALL + F32_ROWS:
            print(json.dumps(f32_case(shape, args.repeats, timed, shape in F32_ROWS)),
                  flush=True)
            torch.cuda.empty_cache()
        return
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
        print(json.dumps(case(shape, args.repeats, timed)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
