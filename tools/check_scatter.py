"""Check and time the in-order scatter-add kernel on the card, alone.

The quick loop for work on ``kernels/scatter/csrc/scatter_add_ordered.cu``,
with ``chip_smoke.py``'s own checks (``_scatter_case``): it builds the
port's kernels, prints what ``ptxas`` reports for the scatter's kernels,
then holds ``scatter_add_ordered`` against its plain version on the CPU bit
for bit, twice, on every contract case of ``kernels/scatter/cases.py`` and
on shapes of the solver paths, made from a seed at the rcv1.binary shape
(N = 20,242 rows of Kr = 111 lanes onto D = 47,236 targets; ``--quick``
skips the large ones):

* ``alpha_step_<r>``: a step's α scatter over the full Kc × Kr tile, live
  where ``r`` rows (one column's) hold entries;
* ``vbar_step_<r>``: a step's v̄ or q̄ scatter, Kc lanes of which ``r`` are
  live, onto n = N distinct rows;
* ``heavy_tile``: every row live, targets by a steeper power law than
  rcv1's (the longest chain ~130,000);
* ``random_repeated``: 2^20 lanes onto 1,000 targets, a power law, 90% live;
* ``one_target_300k``: one target takes 300,000 lanes onto -0.0.

Each shape is timed with CUDA events over 20 back-to-back calls (the
wrapper's allocations included), beside ``index_put_(accumulate=True)`` on
the live lanes and the bound (``chip_smoke.scatter_bound``), and ten calls
run under ``torch.profiler`` (``chip_smoke.scatter_profile``: only the
scatter's kernels, no synchronising call; each kernel's µs a call).  It
prints the card's name and power limit, then one JSON line a case.

    PYTHONPATH=src python tools/check_scatter.py [--quick]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.scatter.cases import CASES, one_hot_target, power_law  # noqa: E402

N, D, KR = 20242, 47236, 111


def tile(g, rows_live: int):
    """(idx (N, KR) int64, live (N, KR)) of a padded row tile whose
    ``rows_live`` rows hold their entries."""
    nnz = np.minimum(1 + (g.pareto(1.2, size=N) * 30).astype(np.int64), KR)
    cols = np.minimum((g.pareto(0.6, size=(N, KR)) * 3).astype(np.int64), D - 1)
    live = np.arange(KR)[None, :] < nnz[:, None]
    keep = np.zeros(N, bool)
    keep[g.permutation(N)[:rows_live]] = True
    return cols, live & keep[:, None]


def shapes(quick: bool) -> dict:
    g = np.random.default_rng(0)
    out = {}
    for rows in (50, 400):
        idx, live = tile(g, rows)
        src = (g.standard_normal(idx.shape) * 1e-3).astype(np.float32)
        out[f"alpha_step_{rows}"] = (np.zeros(D, np.float32), idx, src, live)
    for rows in (60, 3000):
        live = np.zeros(N, bool)
        live[g.permutation(N)[:rows]] = True
        out[f"vbar_step_{rows}"] = (g.standard_normal(N).astype(np.float32),
                                    g.permutation(N).astype(np.int64),
                                    g.standard_normal(N).astype(np.float32), live)
    if not quick:
        idx, live = tile(g, N)
        out["heavy_tile"] = (np.zeros(D, np.float32), idx,
                             g.standard_normal(idx.shape).astype(np.float32), live)
        out["random_repeated"] = power_law(21, 1000, 1 << 20, 0.1)
        out["one_target_300k"] = one_hot_target(300_000)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="the contract cases and step shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("check_scatter: needs a CUDA card")
    chip_smoke.phase_device()
    t0 = time.perf_counter()
    _, info = _lib.build()
    _lib.library()
    ptxas = [ln.strip() for ln in info["log"].split("== scatter_add_ordered.cu")[-1].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": ptxas}), flush=True)
    for name, make in CASES.items():
        args_ = [None if a is None else torch.from_numpy(a) for a in make()]
        print(json.dumps({"case": name, **chip_smoke._scatter_case(*args_, timed=False)}),
              flush=True)
    for name, case in shapes(args.quick).items():
        args_ = [torch.from_numpy(a) for a in case]
        print(json.dumps({"case": name, **chip_smoke._scatter_case(*args_)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
