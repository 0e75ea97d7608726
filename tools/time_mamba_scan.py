"""Time falcon-mamba-7b on the card under three bodies of the scan step of
``repro_torch.models.mamba.scan_chunk``.

* ``out``: each step's products written straight into the new buffers with
  ``torch.mul(..., out=)`` / ``torch.addcmul(..., out=)`` (no temporaries;
  autograd cannot record it);
* ``slice``: each step's products formed, then stored into the new buffers
  by slice assignment (one temporary and one copy a product; autograd
  records it);
* ``cat``: each step's products formed and joined to the first ``step``
  rows by ``torch.cat`` (autograd records it).

All three give the same bits.  The script times the full-width inference
forward (``lm_forward``, bf16, B × S as ``chip_smoke.py`` times it) and one
chunk's scan alone under ``out`` and ``slice``, then a training step's
forward and backward (``lm_loss`` with remat, then ``torch.autograd.grad``;
full width at ``--train-layers`` layers, 1 × S, as ``chip_smoke.py``'s
``lm_train`` phase runs it) under ``cat`` and ``slice``, each pair in the
order A, B, B, A, with CUDA events.  It prints the card's name and power
limit and one JSON line a measurement.

    PYTHONPATH=src python tools/time_mamba_scan.py [--layers 64] [--batch 2] [--seq 2048]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.models import mamba
from repro_torch.models.registry import get_model
from repro_torch.train.tree import tree_leaves


def scan_out(a, b, h):
    n, step = a.shape[1], 1
    while step < n:
        a_next, b_next = torch.empty_like(a), torch.empty_like(b)
        a_next[:, :step], b_next[:, :step] = a[:, :step], b[:, :step]
        torch.mul(a[:, :-step], a[:, step:], out=a_next[:, step:])
        torch.addcmul(b[:, step:], a[:, step:], b[:, :-step], out=b_next[:, step:])
        a, b = a_next, b_next
        step *= 2
    return torch.addcmul(b, a, h[:, None])


def scan_slice(a, b, h):
    n, step = a.shape[1], 1
    while step < n:
        a_next, b_next = torch.empty_like(a), torch.empty_like(b)
        a_next[:, :step], b_next[:, :step] = a[:, :step], b[:, :step]
        a_next[:, step:] = a[:, :-step] * a[:, step:]
        b_next[:, step:] = torch.addcmul(b[:, step:], a[:, step:], b[:, :-step])
        a, b = a_next, b_next
        step *= 2
    return torch.addcmul(b, a, h[:, None])


def scan_cat(a, b, h):
    n, step = a.shape[1], 1
    while step < n:
        a_next = torch.cat([a[:, :step], torch.mul(a[:, :-step], a[:, step:])], dim=1)
        b_next = torch.cat([b[:, :step], torch.addcmul(b[:, step:], a[:, step:], b[:, :-step])],
                           dim=1)
        a, b = a_next, b_next
        step *= 2
    return torch.addcmul(b, a, h[:, None])


FORMS = {"out": scan_out, "slice": scan_slice, "cat": scan_cat}


def _ms(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--train-layers", type=int, default=2)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())

    api = get_model("falcon-mamba-7b", device="cuda", overrides={"n_layers": args.layers})
    cfg = api.cfg
    params = api.init(0)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=torch.Generator().manual_seed(0)).cuda()
    ck = mamba.chunk_len(args.seq)
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.rand((args.batch, ck, cfg.d_inner, cfg.ssm_state), device="cuda", generator=gen)
    b = torch.randn((args.batch, ck, cfg.d_inner, cfg.ssm_state), device="cuda", generator=gen)
    h = torch.randn((args.batch, cfg.d_inner, cfg.ssm_state), device="cuda", generator=gen)

    logits = {}
    with torch.no_grad():
        for name in ("out", "slice", "slice", "out"):
            mamba.scan_chunk = FORMS[name]
            logits.setdefault(name, mamba.lm_forward(params, tokens, cfg))   # warm-up
            fwd = _ms(lambda: mamba.lm_forward(params, tokens, cfg), args.reps)
            scan = _ms(lambda: FORMS[name](a, b, h), 5)
            print(json.dumps({"form": name, "layers": args.layers, "batch": args.batch,
                              "seq": args.seq, "forward_ms": fwd, "scan_chunk_ms": scan,
                              "scan_shape": list(a.shape),
                              "max_memory_allocated": torch.cuda.max_memory_allocated()}))
            torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"same_logits": bool(torch.equal(logits["out"], logits["slice"]))}))
    del params, logits

    tapi = get_model("falcon-mamba-7b", device="cuda", overrides={"n_layers": args.train_layers})
    tparams = tapi.init(0)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = {"tokens": tokens[:1]}
    grads = {}

    def step():
        return torch.autograd.grad(tapi.loss(tparams, batch), leaves)

    torch.cuda.reset_peak_memory_stats()
    for name in ("cat", "slice", "slice", "cat"):
        mamba.scan_chunk = FORMS[name]
        grads.setdefault(name, step())                                      # warm-up
        train = _ms(step, args.reps + 1)
        print(json.dumps({"form": name, "train_layers": args.train_layers, "batch": 1,
                          "seq": args.seq, "train_step_ms": train,
                          "max_memory_allocated": torch.cuda.max_memory_allocated()}))
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"same_grads": all(torch.equal(x, y)
                                        for x, y in zip(grads["cat"], grads["slice"]))}))


if __name__ == "__main__":
    main()
