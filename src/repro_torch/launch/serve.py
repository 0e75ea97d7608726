"""Serving launcher: the continuous-batching engine over an LM of any family but the
encoder-decoder, with random weights from ``--seed`` (port of ``repro.launch.serve``).

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
On the CPU, at the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke \\
      --device cpu --requests 16 --slots 4 --max-new 16
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    api = get_model(args.arch, smoke=args.smoke, device=args.device)
    params = api.init(args.seed)
    engine = ServingEngine(api, params, ServeConfig(slots=args.slots, max_len=args.max_len))

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        engine.submit(Request(
            uid=i, prompt=rng.integers(1, api.cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    finished = engine.run()
    wall = time.time() - t0
    gen_tokens = sum(len(r.generated) for r in finished)
    lat = [r.finished_at - r.submitted_at for r in finished]
    result = {
        "arch": args.arch, "device": (torch.cuda.get_device_name(api.device)
                                      if api.device.type == "cuda" else "cpu"),
        "requests": len(finished),
        "decode_steps": engine.steps, "generated_tokens": gen_tokens,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(gen_tokens / wall, 1),
        "mean_latency_s": round(float(np.mean(lat)), 3),
        "p95_latency_s": round(float(np.percentile(lat, 95)), 3),
        "slot_utilization": round(gen_tokens / max(engine.steps * args.slots, 1), 3),
    }
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
