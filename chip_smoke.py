#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py        # from the repository root; needs one card

It builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card, and drives
the port's solver paths through ``repro_torch.solve`` at the full size of
LIBSVM's rcv1.binary training set (N = 20,242 rows, D = 47,236 features,
~74 nnz per row, made from seed 0 by the port's synthetic generator):

* Alg 2, backend ``torch_sparse``, private and non-private;
* Alg 1, backend ``dense``, for the ``argmax``, ``gumbel`` and
  ``noisy_max`` rules on the padded pair, and on the dense (N, D) matrix;
* both with ``gap_tol`` early stopping (the chunk loop ``drive_chunks``).

It holds the card's runs against CPU runs of the plain versions and the
stopped runs against the fixed-T runs; ``ell_rmatvec`` must equal its plain
version run on the CPU bit for bit (both add in the segmented row order), and
``coord_update`` must meet its bitwise rule against the CPU on both of its
routes (``coord_update/ref.py``), which it times by column length, also on a
copy of the matrix with repeated entries (``duplicates``).  The private step
must run only the rows, owners and draw kernels (``private_window``); the
draw, which rebuilds the touched groups, is held against the plain rebuild
and draw over 1,000 steps of real touched sets; ``ell_matvec`` is swept over
its lane counts and grids, back to back and in the Alg 1 loop.
Then it drives the LM at the full published width of ``tinyllama-1.1b``
(22 layers, d_model 2048, 32 heads, 4 KV heads, random weights from a seed):

* ``forward`` (``last_only``) at B = 4 × S = 2,048 through the flash-attention
  kernel, held in float32 (its CUDA-core route) against the same forward
  with the plain attention, and timed in bfloat16 (its tensor-core route);
* the serving engine (4 slots, 8 requests, greedy), and decode ≡ forward;
* ``examples/dp_lasso_probe.py``'s pipeline: backbone features, a random-ReLU
  expansion and a private ``torch_sparse`` solve on them.

Phases print one JSON line each and raise on any failure (non-zero exit).
The last three lines are the card's name and power limit as ``nvidia-smi``
reports them, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import FWConfig, prng, solve  # noqa: E402
from repro_torch.core.fw_dense import _carry0, _dense_chunk, _dense_step  # noqa: E402
from repro_torch.core.samplers.group_argmax import ga_get_next, ga_init  # noqa: E402
from repro_torch.core import fw_dense  # noqa: E402
from repro_torch.core.samplers.two_level import (rebuild_groups_, tl_init,  # noqa: E402
                                                 tl_rebuild_, tl_scatter_)
from repro_torch.core.solvers.torch_sparse import (em_scale_for, fw_carry_init,  # noqa: E402
                                                   fw_scan_chunk, fw_setup)
from repro_torch.core.sparse.formats import (PaddedCSR, dense_to_host,  # noqa: E402
                                             host_to_padded, tiered_from_padded)
from repro_torch.data.synthetic import (lm_batches, make_sparse_classification,  # noqa: E402
                                        with_repeated_entries)
from repro_torch.kernels import _lib, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bsls_draw import two_level_draw  # noqa: E402
from repro_torch.kernels.bsls_draw.ops import arrival_counter, launch_floor  # noqa: E402
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref  # noqa: E402
from repro_torch.kernels.coord_update import coord_update  # noqa: E402
from repro_torch.kernels.coord_update.ops import (coord_update_scratch,  # noqa: E402
                                                  owner_table, short_route_max_rows)
from repro_torch.kernels.coord_update.ref import (bitwise_rule_mismatches,  # noqa: E402
                                                  coord_update_ref, same_bits)
from repro_torch.kernels.spmv import ell_matvec, ell_rmatvec  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.spmv.ref import SEGMENT, ell_matvec_ref, ell_rmatvec_ref, segments  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models.flash import flash_attention as flash_attention_plain  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402

# rcv1.binary training set (LIBSVM): rows, features, nnz per row
N, D, NNZ_PER_ROW, INFORMATIVE, SEED = 20242, 47236, 74, 64, 0
LAM, T_MAIN, T_PARITY, WARMUP = 50.0, 500, 200, 50
T_DUP, DRAW_STEPS = 50, 1000    # the repeated-entries runs; the rebuilding draw's replay
LOSSES = ("logistic", "squared", "lad", "huber", "smoothed_hinge")
SELECTIONS = ("argmax", "gumbel", "noisy_max")
# H100 SXM datasheet peaks: HBM bytes/s, float32 outside tensor cores,
# bf16 on the tensor cores (dense)
HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 989e12
DEVICE = "cuda"
# the LM: tinyllama-1.1b at full width, prefill batch B x S, the probe's rows
LM_ARCH, LM_B, LM_S, LM_SEED = "tinyllama-1.1b", 4, 2048, 0
PROBE_ROWS, PROBE_SEQ, PROBE_FEATURES, PROBE_T = 512, 32, 4096, 400
# bounds set before the first run: kernel against plain (tests/test_kernels.py's),
# and the float32 logits of the kernel forward against the plain forward
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.06}
# bf16 is held also to the output's own scale: |d| <= 4 eps max(|plain|, the
# row's RMS over hd), eps = 2^-7 the bf16 spacing at 1 (set before its first
# run: rounding the output costs at most 1 and rounding P a fraction of 1,
# while a row off by a relative r reads about r / eps + 1)
FLASH_BF16_ULPS = 4.0
LOGITS_ATOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sync_ms(fn, reps: int = 1) -> float:
    """Host-clock ms per call of ``fn`` over a synchronised window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(launches, sleep_cycles: int = 200_000_000) -> float:
    """Device ms per launch of the callables in ``launches`` (no host sync
    inside them): a sleep kernel holds the stream while the host enqueues,
    so the events time the kernels back to back, not the host."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for fn in launches:
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(launches)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(bound ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": line, "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    path, info = _lib.build()
    _lib.library()
    report = [ln.strip() for ln in info["log"].splitlines()
              if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         cached=info["cached"], library=str(path.relative_to(Path(__file__).resolve().parent)),
         ptxas=report)


def phase_data():
    t0 = time.perf_counter()
    X, y, _ = make_sparse_classification(n=N, d=D, nnz_per_row=NNZ_PER_ROW,
                                         informative=INFORMATIVE, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcsr, pcsc = host_to_padded(X, device=DEVICE)
    torch.cuda.synchronize()
    csc = X.tocsc()
    col_nnz = np.diff(csc.indptr)
    emit("data", n=N, d=D, nnz=X.nnz, max_row_nnz=int(np.diff(X.indptr).max()),
         max_col_nnz=int(col_nnz.max()), p99_col_nnz=int(np.percentile(col_nnz, 99)),
         cols_over_1024=int((col_nnz > 1024).sum()),
         padded_csc_bytes=pcsc.indices.numel() * 8, padded_csr_bytes=pcsr.indices.numel() * 8,
         generate_s=t_gen, pad_on_card_s=time.perf_counter() - t0)
    return X, csc, y, pcsr, pcsc, col_nnz


def column_buckets(col_nnz: np.ndarray) -> dict:
    """A light column (median count), the p99 column and the head column."""
    live = np.flatnonzero(col_nnz > 0)
    pick = lambda target: int(live[np.argmin(np.abs(col_nnz[live] - target))])
    return {"light": pick(np.median(col_nnz[live])), "p99": pick(np.percentile(col_nnz, 99)),
            "head": int(np.argmax(col_nnz))}


def _state_copy(carry):
    s = carry.sampler
    sampler = tl_init(s.v.reshape(-1)[: s.d].clone()) if hasattr(s, "c") else \
        ga_init(s.p.reshape(-1)[: s.d].clone())
    return dict(w=carry.w.clone(), w_m=carry.w_m.clone(), g_tilde=carry.g_tilde.clone(),
                vbar=carry.vbar.clone(), qbar=carry.qbar.clone(),
                alpha=carry.alpha.clone(), queue=sampler)


def _step_kwargs(st, loss, em, gaps, coords, slot, t):
    if gaps is None:     # coord_update_ref's keywords for bitwise_rule_mismatches
        return dict(t=t, lam=LAM, inv_n=1.0 / N, em_scale=em, loss=loss)
    return dict(t=t, lam=LAM, inv_n=1.0 / N, em_scale=em, loss=loss, gaps=gaps,
                coords=coords, slot=slot)


def _run_update(fn, j, pcsr, pcsc, y, st, loss, em, gaps, coords, slot, t=7.0):
    """One step of ``fn`` (the kernel or its plain version), then the queue's
    rebuild by the same side (the draw kernel's rebuild-only launch, or the
    plain ops)."""
    fn(j, pcsr, pcsc, y, st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"],
       st["alpha"], st["queue"], **_step_kwargs(st, loss, em, gaps, coords, slot, t))
    q = st["queue"]
    if hasattr(q, "c"):
        tl_rebuild_(q) if fn is coord_update else rebuild_groups_(q.c, q.v, q.touched)


def phase_kernels_vs_plain(y_t, pcsr, pcsc, buckets, col_nnz) -> dict:
    """Each kernel against its plain version on the card, at the main path's shapes."""
    errs = {}
    # ---- ell_rmatvec: Xᵀq at 20,242 × 111 → 47,236 ------------------------
    q = torch.from_numpy(np.random.default_rng(1).normal(size=N).astype(np.float32)).to(DEVICE)
    got = ell_rmatvec(pcsr, q, pcsc)
    again = ell_rmatvec(pcsr, q, pcsc)
    order = segments(pcsr)
    ref = ell_rmatvec_ref(pcsr.indices, pcsr.values, q, order)
    # the plain version on the card adds with atomics, in no fixed order:
    # |Δ| within 1e-5 of Σ|terms|
    scale = ell_rmatvec_ref(pcsr.indices, pcsr.values.abs(), q.abs(), order)
    err = (got - ref).abs()
    require(bool((err <= 1e-5 * scale + 1e-7).all()), "ell_rmatvec disagrees with plain")
    require(torch.equal(got, again), "ell_rmatvec is not deterministic")
    # on the CPU the plain version adds in the segmented row order: the same bits
    cpu = pcsr.to("cpu")
    t0 = time.perf_counter()
    cpu_order = segments(cpu)
    order_s = time.perf_counter() - t0
    require(torch.equal(got.cpu(), ell_rmatvec_ref(cpu.indices, cpu.values, q.cpu(), cpu_order)),
            "ell_rmatvec differs from its plain version on the CPU")
    tiered = tiered_from_padded(pcsc, int(np.percentile(col_nnz, 99)))
    require(torch.equal(got, ell_rmatvec(pcsr, q, tiered)), "ell_rmatvec: tiered != flat")
    errs["ell_rmatvec"] = float(err.max())
    emit("kernel_vs_plain", kernel="ell_rmatvec", max_abs_err=errs["ell_rmatvec"],
         tolerance="|d| <= 1e-5 * sum|terms| + 1e-7 per column (plain on the card); "
         "bitwise (plain on the CPU)", deterministic=True, equal_to_cpu_plain=True,
         tiered_equal_flat=True, segment=SEGMENT, long_columns=int(order.long_cols.numel()),
         segment_tasks=int(order.tasks.shape[0]), cpu_segment_order_s=order_s)
    del tiered

    # ---- ell_matvec: Xw at 20,242 × 111 → 20,242, a dense and a sparse w -----
    worst = 0.0
    for seed, density in ((3, 1.0), (4, 0.01)):
        rng = np.random.default_rng(seed)
        w_np = (rng.normal(size=D) * (rng.random(D) < density)).astype(np.float32)
        w = torch.from_numpy(w_np).to(DEVICE)
        got, again = ell_matvec(pcsr, w), ell_matvec(pcsr, w)
        ref = ell_matvec_ref(pcsr.indices, pcsr.values, w)
        scale = ell_matvec_ref(pcsr.indices, pcsr.values.abs(), w.abs())
        err = (got - ref).abs()
        require(bool((err <= 1e-5 * scale + 1e-7).all()), "ell_matvec disagrees with plain")
        require(torch.equal(got, again), "ell_matvec is not deterministic")
        worst = max(worst, float(err.max()))
    lengths = ell_matvec_row_lengths(pcsr.indices.shape[1])
    errs["ell_matvec"] = max(worst, lengths["max_abs_err"])
    emit("kernel_vs_plain", kernel="ell_matvec", max_abs_err=errs["ell_matvec"],
         tolerance="|d| <= 1e-5 * sum|terms| + 1e-7 per row", deterministic=True,
         row_lengths=lengths)

    # ---- coord_update: every loss, light / p99 / head column, both queues -----
    worst = 0.0
    for loss in LOSSES:
        setup = fw_setup(pcsr, y_t, loss=loss, pcsc=pcsc)
        for private in (False, True):
            em = 30.0 if private else 1.0
            carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0),
                                  private=private)
            for name, j in buckets.items():
                outs = []
                for fn in (coord_update, coord_update_ref):
                    st = _state_copy(carry)
                    gaps = torch.zeros(2, device=DEVICE)
                    coords = torch.zeros(2, dtype=torch.int32, device=DEVICE)
                    jt = torch.tensor([j], dtype=torch.int32, device=DEVICE)
                    _run_update(fn, jt, pcsr, pcsc, y_t, st, loss, em, gaps, coords, 1)
                    qs = st["queue"]
                    st.update(gaps=gaps, coords=coords.float(),
                              prio=qs.v if private else qs.p,
                              group=qs.c if private else qs.bound)
                    del st["queue"]
                    outs.append(st)
                for key in outs[0]:
                    a, b = outs[0][key], outs[1][key]
                    # α and Δg̃ sum in another order in the plain version (atomics)
                    ok = torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                    require(ok, f"coord_update {loss} private={private} {name}: {key}")
                    worst = max(worst, float((a - b).abs().max()))
    errs["coord_update"] = worst
    routes = coord_update_bitwise(y_t, pcsr, pcsc, buckets)
    emit("kernel_vs_plain", kernel="coord_update", max_abs_err=worst, columns=buckets,
         col_nnz={k: int(col_nnz[v]) for k, v in buckets.items()},
         tolerance="allclose rtol 1e-5 atol 1e-6, every output, 5 losses x 2 queues x 3 "
         "columns (plain on the card, atomics); bitwise rule against the CPU (ref.py "
         "bitwise_rule_mismatches): alpha = line 61 fed the card's gamma, vbar/w/w_m/gap "
         "= coord_update_ref, queue = line-29 refresh of the card's alpha; qbar, g_tilde "
         "allclose", bitwise_rule_cases=len(LOSSES) * 2 * len(buckets),
         route_by_bucket=routes, short_route_max_rows=short_route_max_rows(),
         routes_bitwise_equal=True, rerun_bitwise_equal=True)

    # ---- two_level_draw: 1,000 keys -------------------------------------------
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    em = em_scale_for(FWConfig(backend="torch_sparse", queue="two_level", steps=T_MAIN), N)
    state = tl_init(setup[2].abs() * em)
    _, keys = prng.key_chain(prng.PRNGKey(0), 1000)
    out = torch.empty(len(keys), dtype=torch.int32, device=DEVICE)
    for i, k in enumerate(keys):
        two_level_draw(state.c, state.v, k, out=out[i:i + 1])
    ref = torch.cat([two_level_draw_ref(state.c, state.v, k) for k in keys])
    same = int((out == ref).sum())
    require(same == len(keys), f"two_level_draw: {len(keys) - same} of {len(keys)} differ")
    errs["two_level_draw"] = 0.0
    emit("kernel_vs_plain", kernel="two_level_draw", keys=len(keys), equal=same,
         distinct_indices=int(torch.unique(out).numel()), tolerance="indices equal")
    return errs


def ell_matvec_row_lengths(k_pad: int) -> dict:
    """Each of the kernel's lane counts L (and the default) on rows of 0, 1,
    L-1, L, L+1 and K live entries, at the main path's row width K, against
    the plain version; every grid gives the same bits."""
    lens = sorted({0, 1, k_pad} | {n for lanes in (4, 8, 16, 32)
                                   for n in (lanes - 1, lanes, lanes + 1)})
    gen = torch.Generator().manual_seed(12)
    idx = torch.randint(0, D, (len(lens), k_pad), generator=gen, dtype=torch.int32)
    val = torch.randn(len(lens), k_pad, generator=gen)
    nnz = torch.tensor(lens, dtype=torch.int32)
    live = torch.arange(k_pad)[None, :] < nnz[:, None]
    rows = PaddedCSR(torch.where(live, idx, 0).to(DEVICE), torch.where(live, val, 0.0)
                     .to(DEVICE), nnz.to(DEVICE), (len(lens), D))
    w = torch.randn(D, generator=gen).to(DEVICE)
    ref = ell_matvec_ref(rows.indices, rows.values, w)
    scale = ell_matvec_ref(rows.indices, rows.values.abs(), w.abs())
    worst = 0.0
    for lanes in (0, 4, 8, 16, 32):
        got = ell_matvec(rows, w, lanes=lanes)
        err = (got - ref).abs()
        require(bool((err <= 1e-5 * scale + 1e-7).all()) and float(got[0]) == 0.0,
                f"ell_matvec lanes={lanes} disagrees with plain on rows of {lens} entries")
        for blocks in (1, 2):
            require(torch.equal(got, ell_matvec(rows, w, lanes=lanes, blocks=blocks)),
                    f"ell_matvec lanes={lanes}: the grid changes the bits")
        worst = max(worst, float(err.max()))
    return {"lengths": lens, "max_abs_err": worst, "lanes": [0, 4, 8, 16, 32]}


class _ColumnsOnCPU:
    """``col_live`` of a card's padded CSC, moved to the CPU (the flat CSC of
    the rcv1.binary shape is 7.6 GB; ``coord_update_ref`` reads one column)."""

    def __init__(self, pcsc):
        self.pcsc = pcsc

    def col_live(self, j):
        return tuple(t.cpu() for t in self.pcsc.col_live(j))


def _card_step(j, pcsr, pcsc, y_t, base, loss, em, scratch, route, t=7.0):
    """One kernel step from a copy of ``base`` (no rebuild); returns the state."""
    st = {k: v.clone() for k, v in base.items()}
    gaps = torch.zeros(2, device=DEVICE)
    coords = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    coord_update(torch.tensor([j], dtype=torch.int32, device=DEVICE), pcsr, pcsc, y_t,
                 st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"], st["alpha"],
                 st["queue"], **_step_kwargs(st, loss, em, gaps, coords, 1, t),
                 scratch=scratch, route=route)
    st.update(gaps=gaps[1:], coords=coords[1:])
    return st


def _flat_state(st) -> list:
    q = st["queue"]
    extra = [q.v, q.touched] if hasattr(q, "c") else [q.p, q.bound]
    return [st[k] for k in ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha", "gaps",
                            "coords")] + extra


def coord_update_bitwise(y_t, pcsr, pcsc, buckets) -> dict:
    """The kernel's bitwise rule against the CPU on each bucket's column, every
    loss, both queues; the short and the long route forced on the same column
    give the same bits, and so does a rerun.  Returns the route each bucket
    took (from the kernel's own route counters)."""
    cpu_csr, cpu_cols, y_cpu = pcsr.to("cpu"), _ColumnsOnCPU(pcsc), y_t.cpu()
    n = pcsr.shape[0]
    scratch = coord_update_scratch(n, D, DEVICE)
    taken = {}
    for loss in LOSSES:
        setup = fw_setup(pcsr, y_t, loss=loss, pcsc=pcsc)
        for private in (False, True):
            em = 30.0 if private else 1.0
            carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0),
                                  private=private)
            base = _state_copy(carry)
            before = {k: (v.to("cpu"))
                      for k, v in base.items()}
            for name, j in buckets.items():
                routes0 = scratch.routes.clone()
                card = _card_step(j, pcsr, pcsc, y_t, base, loss, em, scratch, "auto")
                k = int(pcsc.nnz[j])
                gs = scratch.gs[:k].cpu()
                step_route = ("short", "long")[int((scratch.routes - routes0).argmax())]
                taken.setdefault(name, step_route)
                require(taken[name] == step_route, f"coord_update {name}: route changed")
                after = {key: (v.to("cpu"))
                         for key, v in card.items()}
                bad = bitwise_rule_mismatches(j, cpu_csr, cpu_cols, y_cpu, before, after, gs,
                                              **_step_kwargs(None, loss, em, None, None, 0,
                                                             7.0))
                require(not bad, f"coord_update {loss} private={private} {name}: "
                        f"the card breaks the bitwise rule on {bad}")
                flat = _flat_state(card)
                for route in ("short", "long", "auto"):
                    other = _flat_state(_card_step(j, pcsr, pcsc, y_t, base, loss, em,
                                                   scratch, route))
                    require(all(map(same_bits, flat, other)),
                            f"coord_update {loss} private={private} {name}: route {route} "
                            "gives other bits")
    return taken


def duality_gap(pcsr, y, w) -> float:
    """FW duality gap of the logistic objective at w: ⟨w, ∇f⟩ + λ‖∇f‖∞ (plain ops)."""
    r = torch.sigmoid(pcsr.matvec(w)) - torch.from_numpy(y.astype(np.float32)).to(w.device)
    grad = ell_rmatvec_ref(pcsr.indices, pcsr.values, r, segments(pcsr)) / N
    return float(torch.dot(w, grad) + LAM * grad.abs().max())


def phase_main_path(pcsr, pcsc, y) -> dict:
    """The port's main path through ``solve`` at full size, private and not."""
    runs = {}
    for private in (True, False):
        cfg = FWConfig(backend="torch_sparse", lam=LAM, steps=T_MAIN, loss="logistic",
                       epsilon=1.0, delta=1e-6,
                       queue="two_level" if private else "group_argmax", device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve((pcsr, pcsc), y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = {"coord_update": T_MAIN, "two_level_draw": T_MAIN if private else 0,
                "ell_rmatvec": 2, "ell_matvec": 0, "flash_attention": 0}
        require(counts == want, f"launch counts {counts}, expected {want}")
        require(two_level_draw.rebuilds == int(private),
                f"rebuild-only launches {two_level_draw.rebuilds}, expected {int(private)}")
        gaps = res.gaps.cpu().numpy()
        require(bool(np.isfinite(gaps).all()) and bool(torch.isfinite(res.w).all()),
                "non-finite output")
        require(int((res.w != 0).sum()) <= T_MAIN, "more nonzeros than steps")
        if not private:
            # exact argmax: g_t is the FW duality gap at the step's iterate
            require(gaps[-1] < gaps[0], f"gap did not fall: {gaps[0]} -> {gaps[-1]}")
        # (private: g_t is read at a DP-drawn coordinate, not a certificate;
        # the duality gap at w_0 and w_T is reported beside it)
        name = "private" if private else "non_private"
        runs[name] = dict(res=res, counts=counts, wall=wall)
        if private:
            again = solve((pcsr, pcsc), y, cfg)
            require(torch.equal(again.w, res.w) and torch.equal(again.coords, res.coords),
                    "two private runs differ")
        emit("main_path", run=name, queue=cfg.queue, steps=T_MAIN, lam=LAM,
             solve_s=wall, launches=counts, rebuild_only_launches=int(private),
             gap_first=float(gaps[0]),
             gap_last=float(gaps[-1]), duality_gap_w0=duality_gap(pcsr, y, torch.zeros_like(res.w)),
             duality_gap_wT=duality_gap(pcsr, y, res.w), nnz_w=int((res.w != 0).sum()),
             distinct_coords=int(torch.unique(res.coords).numel()),
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             bitwise_equal_rerun=True if private else None)
    return runs


def phase_step_times(pcsr, pcsc, y_t) -> dict:
    """Setup ms and per-step ms of Alg 2 (host clock, synchronised)."""
    per_step = {}
    setup_ms = sync_ms(lambda: fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc), reps=5)
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    for private in (True, False):
        cfg = FWConfig(backend="torch_sparse", steps=T_MAIN,
                       queue="two_level" if private else "group_argmax")
        em = em_scale_for(cfg, N)
        carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0), private=private)
        kw = dict(loss="logistic", private=private)
        fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0, 0, None, steps=WARMUP, **kw)
        steps = T_MAIN - WARMUP
        pops0 = getattr(carry.sampler, "pops", 0)
        ms = sync_ms(lambda: fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0, WARMUP, None,
                                           steps=steps, **kw)) / steps
        fields = dict(setup_ms=setup_ms, per_step_ms=ms, window_steps=steps,
                      warmup_steps=WARMUP)
        if not private:
            # the host lazy-repair queue: pops per step, and one call's cost on
            # the final (repaired) state, where it pops once
            fields.update(ga_pops_per_step=(carry.sampler.pops - pops0) / steps,
                          ga_one_pop_call_ms=sync_ms(lambda: ga_get_next(carry.sampler), 200))
        emit("step_time", run="private" if private else "non_private", **fields)
        per_step["private" if private else "non_private"] = ms
    em = em_scale_for(FWConfig(backend="torch_sparse", steps=T_MAIN, queue="two_level"), N)
    carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0), private=True)
    kw = dict(loss="logistic", private=True)
    fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0, 0, None, steps=WARMUP, **kw)
    prof = profile_steps("private", 100, lambda: fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0,
                                                                WARMUP, None, steps=100, **kw))
    return per_step, private_window(prof, 100)


# the kernels of a private step: coord_update's two and the rebuilding draw
PRIVATE_STEP_KERNELS = ("rows_kernel", "owners_kernel", "two_level_draw_kernel<true>")


def _device_ms_of(prof: dict, name: str) -> tuple:
    """(device ms, calls) of the profiled kernels whose name holds ``name``."""
    return (sum(ms for k, ms in prof["by_kernel"].items() if name in k),
            sum(c for k, c in prof["calls"].items() if name in k))


def private_window(prof: dict, steps: int) -> dict:
    """The private step runs the rows, owners and draw kernels once each and
    no other device kernel once a step or more (the rebuild's torch ops are
    gone: the draw launch rebuilds)."""
    calls = {name: _device_ms_of(prof, name)[1] for name in PRIVATE_STEP_KERNELS}
    require(all(c == steps for c in calls.values()),
            f"private window: {calls}, expected {steps} calls of each")
    others = {k[:80]: c for k, c in prof["calls"].items()
              if c >= steps and not any(name in k for name in PRIVATE_STEP_KERNELS)}
    require(not others, f"private window: other kernels launched every step: {others}")
    fields = dict(steps=steps, calls=calls, kernels_per_step=sum(prof["calls"].values()) / steps,
                  device_ms_per_step={name: _device_ms_of(prof, name)[0] / steps
                                      for name in PRIVATE_STEP_KERNELS},
                  other_kernels={k[:80]: c for k, c in prof["calls"].items()
                                 if not any(name in k for name in PRIVATE_STEP_KERNELS)})
    emit("private_window", **fields)
    return fields


def profile_steps(run: str, steps: int, window, quiet: bool = False) -> dict:
    """Device time by kernel over ``window()``, a run of ``steps`` steps
    (torch.profiler); returns the device ms by kernel name (``quiet``: no
    phase line)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: CPU ops also carry the device time of their kernels
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    if quiet:
        return {"wall_ms": wall_ms, "by_kernel": {k: ms for k, ms, _ in by_kernel},
                "calls": {k: c for k, _, c in by_kernel}}
    emit("profile", run=run, steps=steps, wall_ms_profiled=wall_ms,
         device_busy_ms=busy_ms if by_kernel else None,
         device_idle_share=(1.0 - busy_ms / wall_ms) if by_kernel else None,
         top_device=[{"name": k[:80], "ms": ms, "calls": c} for k, ms, c in by_kernel[:8]],
         note=None if by_kernel else "the profiler recorded no device time")
    return {"wall_ms": wall_ms, "by_kernel": {k: ms for k, ms, _ in by_kernel},
            "calls": {k: c for k, _, c in by_kernel}}


def _alg1_config(selection: str, steps: int) -> FWConfig:
    return FWConfig(backend="dense", lam=LAM, steps=steps, loss="logistic",
                    selection=selection, epsilon=1.0, delta=1e-6, device=DEVICE)


def phase_alg1(pcsr, pcsc, y) -> dict:
    """Alg 1 through ``solve`` on the padded pair at full size, each rule."""
    runs = {}
    for sel in SELECTIONS:
        cfg = _alg1_config(sel, T_MAIN)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve((pcsr, pcsc), y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = {"ell_matvec": T_MAIN, "ell_rmatvec": T_MAIN + 1, "coord_update": 0,
                "two_level_draw": 0, "flash_attention": 0}
        require(counts == want, f"Alg 1 {sel}: launch counts {counts}, expected {want}")
        gaps, losses = res.gaps.cpu().numpy(), res.losses.cpu().numpy()
        require(bool(np.isfinite(gaps).all() and np.isfinite(losses).all()
                     and torch.isfinite(res.w).all()), f"Alg 1 {sel}: non-finite output")
        require(int((res.w != 0).sum()) <= T_MAIN, f"Alg 1 {sel}: more nonzeros than steps")
        require(res.stop_step == T_MAIN and res.stop_reason == "max_steps",
                f"Alg 1 {sel}: stop {res.stop_step} {res.stop_reason}")
        if sel == "argmax":   # exact selection: g_t is the duality gap at w_t
            require(gaps[-1] < gaps[0] and losses[-1] < losses[0],
                    f"Alg 1 argmax did not descend: gap {gaps[0]} -> {gaps[-1]}, "
                    f"loss {losses[0]} -> {losses[-1]}")
            again = solve((pcsr, pcsc), y, cfg)
            require(torch.equal(again.w, res.w) and torch.equal(again.coords, res.coords),
                    "two Alg 1 argmax runs differ")
        runs[sel] = dict(res=res, counts=counts, wall=wall)
        emit("alg1_path", selection=sel, steps=T_MAIN, lam=LAM, solve_s=wall, launches=counts,
             gap_first=float(gaps[0]), gap_last=float(gaps[-1]), loss_first=float(losses[0]),
             loss_last=float(losses[-1]), duality_gap_wT=duality_gap(pcsr, y, res.w),
             nnz_w=int((res.w != 0).sum()),
             distinct_coords=int(torch.unique(res.coords).numel()),
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             bitwise_equal_rerun=True if sel == "argmax" else None)
    return runs


def phase_alg1_step_times(pcsr, pcsc, y_t) -> tuple:
    """Per-step ms of Alg 1 for each rule (the same window as Alg 2's), and
    the device time of the spmv kernels in a profiled window of 100 steps
    (``noisy_max`` runs the same kernels as ``gumbel``)."""
    per_step, share = {}, {}
    for sel in SELECTIONS:
        cfg = _alg1_config(sel, T_MAIN)
        step = _dense_step((pcsr, pcsc), y_t, cfg, masked=False)
        carry, _ = _dense_chunk(step, _carry0((pcsr, pcsc), D, cfg), 0, WARMUP, masked=False)
        steps = T_MAIN - WARMUP
        per_step[sel] = sync_ms(lambda: _dense_chunk(step, carry, WARMUP, steps,
                                                     masked=False)) / steps
        emit("alg1_step_time", selection=sel, per_step_ms=per_step[sel], window_steps=steps,
             warmup_steps=WARMUP)
        if sel == "noisy_max":
            continue
        prof = profile_steps(f"alg1_{sel}", 100,
                             lambda: _dense_chunk(step, carry, WARMUP, 100, masked=False))
        # device ms per step of each spmv kernel, and its share of the
        # profiled and of the unprofiled step
        share[sel] = {name: {"device_ms_per_step": ms / 100,
                             "of_profiled_step": ms / prof["wall_ms"],
                             "of_step": ms / 100 / per_step[sel]}
                      for name in ("ell_rmatvec", "ell_matvec")
                      for ms in [sum(v for k, v in prof["by_kernel"].items() if name in k)]}
        for name, row in share[sel].items():   # a renamed kernel must not read as 0
            require(row["device_ms_per_step"] > 0, f"alg1_{sel}: no device time for {name}")
    emit("alg1_kernel_share", steps=100, share=share)
    return per_step, share


def phase_parity(X, y, pcsr, pcsc, col_nnz) -> None:
    """Card against CPU (plain versions) at full width, T = 200."""
    t0 = time.perf_counter()
    cpu_pair = host_to_padded(X, device="cpu")
    t_pad = time.perf_counter() - t0
    width = int(np.percentile(col_nnz, 99))
    tiered = tiered_from_padded(pcsc, width)
    for private in (True, False):
        cfg = FWConfig(backend="torch_sparse", lam=LAM, steps=T_PARITY, epsilon=1.0,
                       delta=1e-6, queue="two_level" if private else "group_argmax",
                       device=DEVICE)
        card = solve((pcsr, pcsc), y, cfg)
        t0 = time.perf_counter()
        cpu = solve(cpu_pair, y, dataclasses.replace(cfg, device="cpu"))
        t_cpu = time.perf_counter() - t0
        differ = (card.coords.cpu() != cpu.coords).nonzero().flatten().tolist()
        require(not differ, f"card/CPU coords differ (private={private}) at steps {differ[:5]}")
        dw = float((card.w.cpu() - cpu.w).abs().max())
        dg = float((card.gaps.cpu() - cpu.gaps).abs().max())
        require(dw <= 1e-4 and dg <= 1e-4, f"card/CPU w or gaps differ: {dw}, {dg}")
        fields = dict(run="private" if private else "non_private", steps=T_PARITY,
                      coords_equal=True, max_abs_w=dw, max_abs_gaps=dg, cpu_solve_s=t_cpu,
                      cpu_pad_s=t_pad)
        if private:
            tr = solve((pcsr, tiered), y, cfg)
            require(torch.equal(tr.coords, card.coords), "tiered coords differ from flat")
            fields.update(tiered_width=width, tiered_heavy_cols=int((col_nnz > width).sum()),
                          tiered_coords_equal=True,
                          tiered_max_abs_w=float((tr.w - card.w).abs().max()))
        emit("card_vs_cpu", **fields)
    phase_alg1_parity(X, y, pcsr, pcsc, cpu_pair)


def phase_alg1_parity(X, y, pcsr, pcsc, cpu_pair) -> None:
    """Alg 1 card against CPU at T = 200: argmax must take the CPU's
    coordinates; for the private rules, whose noise goes through torch's
    log/log1p (an ulp from the CPU's), a differing step is reported.  Then
    the dense (N, D) form on the card must take the padded form's argmax
    coordinates."""
    for sel in SELECTIONS:
        cfg = _alg1_config(sel, T_PARITY)
        card = solve((pcsr, pcsc), y, cfg)
        t0 = time.perf_counter()
        cpu = solve(cpu_pair, y, dataclasses.replace(cfg, device="cpu"))
        t_cpu = time.perf_counter() - t0
        differ = (card.coords.cpu() != cpu.coords).nonzero().flatten().tolist()
        fields = dict(run=f"alg1_{sel}", steps=T_PARITY, coords_equal=not differ,
                      differing_steps=[i + 1 for i in differ[:10]], cpu_solve_s=t_cpu)
        if not differ:
            fields.update({f"max_abs_{k}": float((getattr(card, k).cpu() - getattr(cpu, k))
                                                 .abs().max()) for k in ("w", "gaps", "losses")})
        emit("card_vs_cpu", **fields)
        if sel == "argmax":
            require(not differ,
                    f"Alg 1 card/CPU coords differ at steps {fields['differing_steps']}")
            require(all(fields[f"max_abs_{k}"] <= 1e-4 for k in ("w", "gaps", "losses")),
                    f"Alg 1 card/CPU w, gaps or losses differ: {fields}")
            padded = card
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    dense = solve(X, y, _alg1_config("argmax", T_PARITY))   # HostCSR → (N, D) on the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    differ = (dense.coords != padded.coords).nonzero().flatten().tolist()
    require(not differ, f"dense-matrix Alg 1 coords differ from the padded run at {differ[:5]}")
    emit("alg1_dense_matrix", steps=T_PARITY, matrix_bytes=4 * N * D, solve_s=wall,
         launches=launch_counts(), coords_equal_padded=True,
         max_abs_w_vs_padded=float((dense.w - padded.w).abs().max()),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del dense


def _alg2_scan(pair, y, private: bool, route: str) -> tuple:
    """A T_DUP-step Alg 2 run on ``pair``'s device with ``coord_update``'s
    route forced; returns (w, gaps, coords) on the CPU."""
    pcsr, pcsc = pair
    cfg = FWConfig(backend="torch_sparse", lam=LAM, steps=T_DUP, epsilon=1.0, delta=1e-6,
                   queue="two_level" if private else "group_argmax")
    em = em_scale_for(cfg, N)
    y_dev = torch.from_numpy(y.astype(np.float32)).to(pcsr.device)
    setup = fw_setup(pcsr, y_dev, loss="logistic", pcsc=pcsc)
    carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0), private=private)
    carry, (gaps, coords) = fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0, 0, None,
                                          steps=T_DUP, loss="logistic", private=private,
                                          route=route)
    return (carry.w * carry.w_m).cpu(), gaps.cpu(), coords.cpu()


def phase_duplicates(X, csc, y, y_t, buckets) -> None:
    """Repeated entries (a row that lists a column twice), at the rcv1.binary
    shape: the head, p99 and light columns each get repeated entries (3, 3
    and 1 of their rows' entries listed again in the HostCSR, not summed),
    and 5,000 entries anywhere (so the private runs draw such columns too).  The card must meet the kernel's bitwise rule
    against the CPU on those columns (every loss, both queues, both routes
    and a rerun the same bits), and T_DUP-step runs with each route forced
    must take the CPU's coordinates and w bit for bit, the gaps within 1e-4
    (g̃'s sum is held allclose by the rule)."""
    rng = np.random.default_rng(21)
    rows, cols = [], []
    for name, k in (("head", 3), ("p99", 3), ("light", 1)):
        c = buckets[name]
        rows += list(rng.choice(csc.indices[csc.indptr[c]:csc.indptr[c + 1]], k, replace=False))
        cols += [c] * k
    for i in rng.choice(N, 5000, replace=False):
        rows.append(int(i))
        cols.append(int(rng.choice(X.row(int(i))[0])))
    Xd = with_repeated_entries(X, rows, cols, seed=22)
    pcsr, pcsc = host_to_padded(Xd, device=DEVICE)
    owners = owner_table(pcsc)
    require(all(int(owners.col_repeats[c]) == 1 for c in buckets.values()),
            "duplicates: a bucket column lists no row twice")
    t0 = time.perf_counter()
    routes = coord_update_bitwise(y_t, pcsr, pcsc, buckets)
    rule_s = time.perf_counter() - t0
    cpu_pair = host_to_padded(Xd, device="cpu")
    runs = {}
    for private in (True, False):
        w_cpu, gaps_cpu, coords_cpu = _alg2_scan(cpu_pair, y, private, "auto")
        picked = int(owners.col_repeats.cpu()[coords_cpu.long()].sum())
        for route in ("short", "long"):
            w, gaps, coords = _alg2_scan((pcsr, pcsc), y, private, route)
            name = f"{'private' if private else 'non_private'}_{route}"
            differ = (coords != coords_cpu).nonzero().flatten().tolist()
            require(not differ, f"duplicates {name}: card/CPU coords differ at {differ[:5]}")
            require(torch.equal(w, w_cpu), f"duplicates {name}: card/CPU w differ")
            dg = float((gaps - gaps_cpu).abs().max())
            require(dg <= 1e-4, f"duplicates {name}: card/CPU gaps differ by {dg}")
            runs[name] = dict(coords_equal=True, w_bitwise_equal=True, max_abs_gaps=dg,
                              steps_on_repeated_columns=picked)
    emit("duplicates", repeated_entries=len(rows), nnz=int(Xd.nnz),
         columns=buckets, col_nnz={k: int(pcsc.nnz[v]) for k, v in buckets.items()},
         columns_listing_a_row_twice=int(owners.col_repeats.sum()),
         rows_listing_a_column_twice=int(owners.row_repeats.sum()),
         lane_term_slots=owners.slots, bitwise_rule_cases=len(LOSSES) * 2 * len(buckets),
         route_by_bucket=routes, routes_bitwise_equal=True, bitwise_rule_s=rule_s,
         steps=T_DUP, runs=runs)
    del pcsr, pcsc, cpu_pair
    torch.cuda.empty_cache()


def phase_gap_tol(pcsr, pcsc, y, runs, alg1) -> None:
    """gap_tol runs through the chunk loop: each stops before T and is a
    bitwise prefix of its fixed-T run, with sentinels after the stop."""
    fixed = {"dense_argmax": (alg1["argmax"]["res"], _alg1_config("argmax", T_MAIN))}
    for name in ("private", "non_private"):
        fixed[f"torch_sparse_{name}"] = (runs[name]["res"], FWConfig(
            backend="torch_sparse", lam=LAM, steps=T_MAIN, epsilon=1.0, delta=1e-6,
            queue="two_level" if name == "private" else "group_argmax", device=DEVICE))
    for name, (full, cfg) in fixed.items():
        gaps = full.gaps.cpu().numpy()
        # the least positive gap of the first T/2 steps, so the stop lands in
        # the first half even on a private trace, which is read at DP-drawn
        # coordinates, need not fall and may dip below zero (the gap at step
        # T/2 itself can lie above the first step's); the expected stop is
        # the fixed run's first step at or below it
        half = gaps[: T_MAIN // 2]
        tol = float(half[half > 0].min())
        k = int(np.argmax(gaps <= np.float32(tol)))
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve((pcsr, pcsc), y, dataclasses.replace(cfg, gap_tol=tol))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stop = res.stop_step_or()
        require(res.stop_reason == "gap_tol" and stop == k + 1 < T_MAIN,
                f"{name}: stopped at {stop} ({res.stop_reason}), expected {k + 1}")
        require(torch.equal(res.coords[:stop], full.coords[:stop])
                and torch.equal(res.gaps[:stop], full.gaps[:stop]),
                f"{name}: the stopped run is not a prefix of the fixed-T run")
        require(bool((res.coords[stop:] == -1).all() and (res.gaps[stop:] == 0).all()),
                f"{name}: no sentinels after the stop")
        emit("gap_tol", run=name, expected_stop_step=k + 1, gap_tol=tol, stop_step=stop,
             stop_reason=res.stop_reason, prefix_bitwise_equal=True, solve_s=wall,
             launches=launch_counts())


def _coord_update_bytes(X, csc, coords, group_size: int) -> tuple:
    """Bytes and flops one run's coord_update launches must move / do."""
    nbytes = ops = 0.0
    for j in coords:
        rows = csc.indices[csc.indptr[j]:csc.indptr[j + 1]]
        nc = rows.size
        ents = np.concatenate([X.indices[X.indptr[i]:X.indptr[i + 1]] for i in rows]) \
            if nc else np.zeros(0, np.int64)
        u = np.unique(ents).size
        g = np.unique(ents // group_size).size
        # column ids+values, v̄/q̄ read+write, row nnz, row ids+values,
        # w/α read at touched columns, α and the priority written, group flag/bound
        nbytes += 8 * nc + 20 * nc + 8 * ents.size + 8 * u + 8 * u + 4 * g + 32
        ops += 12 * nc + 6 * ents.size
    n = max(len(coords), 1)
    return nbytes / n, ops / n


def phase_kernel_times(X, csc, y_t, pcsr, pcsc, runs, alg1, buckets, errs, share,
                       window) -> list:
    """Times of each kernel at the main paths' shapes, against its bound.
    ``launches``: the Alg 1 argmax solve's count for the spmv kernels, the
    private Alg 2 solve's for the others (each phase line has every run's).
    The spmv kernels' ``in_loop_ms`` is their profiled device ms per Alg 1
    ``argmax`` step, beside ``ms`` timed back to back; the draw's is its
    device ms per step of the profiled private window.  ``launch_floor_ms``:
    an empty kernel's device ms, timed the same way (the practical floor of
    the latency-bound rows)."""
    kernels = []
    floor = device_ms([launch_floor] * 1000)
    # ---- ell_rmatvec --------------------------------------------------------
    q = torch.from_numpy(np.random.default_rng(2).normal(size=N).astype(np.float32)).to(DEVICE)
    ms = device_ms([lambda: ell_rmatvec(pcsr, q, pcsc)] * 20)
    plain = device_ms([lambda: ell_rmatvec_ref(pcsr.indices, pcsr.values, q,
                                               segments(pcsr))] * 20)
    crow = torch.from_numpy(csc.indptr).to(DEVICE)
    xt = torch.sparse_csr_tensor(crow, torch.from_numpy(csc.indices).to(DEVICE),
                                 torch.from_numpy(csc.data.astype(np.float32)).to(DEVICE),
                                 size=(D, N))
    lib_out = torch.sparse.mm(xt, q[:, None])[:, 0]
    require(torch.allclose(lib_out, ell_rmatvec(pcsr, q, pcsc), rtol=1e-4, atol=1e-5),
            "torch.sparse.mm disagrees with ell_rmatvec")
    lib = device_ms([lambda: torch.sparse.mm(xt, q[:, None])] * 20)
    b, by = bound(8.0 * X.nnz + 4.0 * N + 8.0 * D, 2.0 * X.nnz)
    kernels.append(dict(name="ell_rmatvec", route="cuda",
                        source="src/repro_torch/kernels/spmv/csrc/ell_rmatvec.cu",
                        replaces="src/repro/kernels/spmv/kernel.py:96",
                        launches=alg1["argmax"]["counts"]["ell_rmatvec"],
                        max_abs_err=errs["ell_rmatvec"], ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=lib,
                        in_loop_ms=share["argmax"]["ell_rmatvec"]["device_ms_per_step"]))
    # ---- ell_matvec: the Alg 1 margins, at the argmax run's final w ------------
    w = alg1["argmax"]["res"].w
    ms = device_ms([lambda: ell_matvec(pcsr, w)] * 50)
    plain = device_ms([lambda: ell_matvec_ref(pcsr.indices, pcsr.values, w)] * 20)
    xr = torch.sparse_csr_tensor(torch.from_numpy(X.indptr).to(DEVICE),
                                 torch.from_numpy(X.indices).to(DEVICE),
                                 torch.from_numpy(X.data.astype(np.float32)).to(DEVICE),
                                 size=(N, D))
    lib_out = torch.sparse.mm(xr, w[:, None])[:, 0]
    require(torch.allclose(lib_out, ell_matvec(pcsr, w), rtol=1e-4, atol=1e-5),
            "torch.sparse.mm disagrees with ell_matvec")
    lib = device_ms([lambda: torch.sparse.mm(xr, w[:, None])] * 50)
    sweep = ell_matvec_sweep(pcsr, pcsc, y_t, w)
    b, by = bound(8.0 * X.nnz + 8.0 * N + 4.0 * D, 2.0 * X.nnz)
    kernels.append(dict(name="ell_matvec", route="cuda",
                        source="src/repro_torch/kernels/spmv/csrc/ell_matvec.cu",
                        replaces="src/repro/kernels/spmv/kernel.py:55",
                        launches=alg1["argmax"]["counts"]["ell_matvec"],
                        max_abs_err=errs["ell_matvec"], ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=lib,
                        in_loop_ms=share["argmax"]["ell_matvec"]["device_ms_per_step"],
                        lanes_grid_sweep=sweep, launch_floor_ms=floor))
    # ---- two_level_draw: the rebuilding draw over real touched sets -----------
    draw = draw_rebuild_check(pcsr, pcsc, y_t, runs["private"]["res"].coords.cpu().numpy())
    kernels.append(dict(name="two_level_draw", route="cuda",
                        source="src/repro_torch/kernels/bsls_draw/csrc/two_level_draw.cu",
                        replaces="src/repro/kernels/bsls_draw/kernel.py:62",
                        launches=runs["private"]["counts"]["two_level_draw"],
                        max_abs_err=draw["max_abs_c_err"], ms=draw["ms"],
                        plain_ms=draw["plain_ms"], bound_ms=draw["bound_ms"],
                        bound_by=draw["bound_by"], library_ms=None,
                        in_loop_ms=window["device_ms_per_step"]["two_level_draw_kernel<true>"],
                        draw_only_ms=draw["draw_only_ms"], launch_floor_ms=floor))
    kernels.append(coord_update_times(X, csc, y_t, pcsr, pcsc, runs, buckets, errs))
    kernels[-1]["launch_floor_ms"] = floor
    return kernels


class _matvec_shape:
    """Within the block, Alg 1's margins launch ``ell_matvec`` with the given
    lane count and grid."""

    def __init__(self, lanes: int, blocks: int):
        self.lanes, self.blocks = lanes, blocks

    def __enter__(self):
        fw_dense.ell_matvec = lambda X, w: ell_matvec(X, w, lanes=self.lanes,
                                                      blocks=self.blocks)

    def __exit__(self, *exc):
        fw_dense.ell_matvec = ell_matvec


def ell_matvec_sweep(pcsr, pcsc, y_t, w) -> list:
    """``ell_matvec`` with L = 4, 8, 16, 32 lanes a row, each on a grid that
    covers the rows once and on smaller grids that stride (1,056 = 8 resident
    blocks on each of 132 SMs, the default, 528, 264): device ms back to
    back, and in the Alg 1 argmax loop (profiled device ms per step over 100
    steps).  For one L, every grid gives the same bits."""
    cfg = _alg1_config("argmax", T_MAIN)
    step = _dense_step((pcsr, pcsc), y_t, cfg, masked=False)
    carry, _ = _dense_chunk(step, _carry0((pcsr, pcsc), D, cfg), 0, WARMUP, masked=False)
    rows = []
    for lanes in (4, 8, 16, 32):
        cover = -(-N // (256 // lanes))
        want = ell_matvec(pcsr, w, lanes=lanes)
        for blocks in [b for b in dict.fromkeys((cover, 1056, 528, 264)) if b <= cover]:
            require(torch.equal(ell_matvec(pcsr, w, lanes=lanes, blocks=blocks), want),
                    f"ell_matvec lanes={lanes}: the grid changes the bits")
            ms = device_ms([lambda: ell_matvec(pcsr, w, lanes=lanes, blocks=blocks)] * 50)
            with _matvec_shape(lanes, blocks):
                prof = profile_steps("alg1_matvec_sweep", 100, lambda: _dense_chunk(
                    step, carry, WARMUP, 100, masked=False), quiet=True)
            # the profiler may drop an event of a window: ms per recorded launch
            in_loop, calls = _device_ms_of(prof, "ell_matvec_kernel")
            require(90 <= calls <= 100, f"ell_matvec sweep: {calls} profiled launches")
            rows.append(dict(lanes=lanes, blocks=blocks, grid="covers" if blocks == cover
                             else "strides", ms=ms, in_loop_ms=in_loop / calls,
                             profiled_launches=calls))
    emit("ell_matvec_sweep", rows=rows, default_lanes=32, default_blocks=1056)
    return rows


def draw_rebuild_check(pcsr, pcsc, y_t, coords) -> dict:
    """The rebuilding draw over DRAW_STEPS steps, each a ``tl_scatter_`` of a
    real touched set (the coordinates of the rows of a column the private
    main-path run selected, in its order, over again), new log-weights near
    the old ones, then the launch: ``c`` within rtol/atol 1e-6 of the plain
    rebuild, the draw equal to the plain draw on the kernel's ``c``, no group
    left touched and the arrival counter at 0 after each launch.  A masked
    launch rebuilds and writes -1.  The launch's device ms at these sets
    (profiled replay), the plain version's host ms, and the bound at the
    mean touched groups."""
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    em = em_scale_for(FWConfig(backend="torch_sparse", queue="two_level", steps=T_MAIN), N)
    state = tl_init(setup[2].abs() * em)
    plain = state.clone()
    counter = arrival_counter(DEVICE)
    _, keys = prng.key_chain(prng.PRNGKey(9), DRAW_STEPS)
    gen = torch.Generator(DEVICE).manual_seed(4)
    sets = []
    for i in range(DRAW_STEPS):
        rows = pcsc.col_live(int(coords[i % len(coords)]))[0].long()
        live = torch.arange(pcsr.indices.shape[1], device=DEVICE)[None, :] < \
            pcsr.nnz[rows][:, None]
        idx = torch.unique(pcsr.indices[rows][live].long())   # one value per coordinate
        vals = state.v.view(-1)[idx] * (1.0 + 0.05 * torch.randn(idx.numel(), generator=gen,
                                                                  device=DEVICE))
        sets.append((idx, vals))
    worst, touched_groups = 0.0, 0
    for (idx, vals), k in zip(sets, keys):
        for st in (state, plain):
            tl_scatter_(st, idx, vals)
        touched_groups += int(state.touched.sum())
        got = two_level_draw(state.c, state.v, k, touched=state.touched)
        rebuild_groups_(plain.c, plain.v, plain.touched)
        require(torch.allclose(state.c, plain.c, rtol=1e-6, atol=1e-6),
                "rebuilding draw: c differs from the plain rebuild")
        worst = max(worst, float((state.c - plain.c).abs().max()))
        require(int(got) == int(two_level_draw_ref(state.c, state.v, k)),
                "rebuilding draw: the draw differs from the plain draw on its c")
        require(int(state.touched.sum()) == 0 and int(counter) == 0,
                "rebuilding draw: a group left touched or the counter not at 0")
        plain.c.copy_(state.c)
    idx, vals = sets[0]
    for st in (state, plain):
        tl_scatter_(st, idx, vals * 1.1)
    rebuild_groups_(plain.c, plain.v, plain.touched)
    out = two_level_draw(state.c, state.v, keys[0], touched=state.touched,
                         done=torch.tensor(True, device=DEVICE))
    require(int(out) == -1 and int(state.touched.sum()) == 0 and int(counter) == 0
            and torch.allclose(state.c, plain.c, rtol=1e-6, atol=1e-6),
            "masked rebuilding draw: no sentinel, or the touched groups not rebuilt")
    # timing: the launches alone over the same sets (profiled), the plain version
    def replay(fn):
        for (idx, vals), k in zip(sets, keys):
            tl_scatter_(state, idx, vals)
            fn(k)
    prof = profile_steps("draw_replay", DRAW_STEPS, lambda: replay(
        lambda k: two_level_draw(state.c, state.v, k, touched=state.touched)), quiet=True)
    # the profiler may drop an event of a window: ms per recorded launch
    ms, calls = _device_ms_of(prof, "two_level_draw_kernel<true>")
    require(0.99 * DRAW_STEPS <= calls <= DRAW_STEPS,
            f"rebuilding draw replay: {calls} profiled launches")
    t0 = time.perf_counter()
    replay(lambda k: two_level_draw_ref(state.c, state.v, k, touched=state.touched))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / DRAW_STEPS
    out = torch.empty(1, dtype=torch.int32, device=DEVICE)
    draw_only = device_ms([lambda k=k: two_level_draw(state.c, state.v, k, out=out)
                           for k in keys])
    g, m = state.v.shape
    tg = touched_groups / DRAW_STEPS
    b, by = bound(4.0 * (2 * g + m + 1) + tg * (4.0 * m + 8.0),
                  125.0 * (g + m) + 230.0 + tg * 4.0 * m)
    fields = dict(steps=DRAW_STEPS, max_abs_c_err=worst, c_tolerance="rtol 1e-6, atol 1e-6",
                  draws_equal=True, touched_after=0, counter_after=0, masked_sentinel=True,
                  mean_touched_groups=tg, groups=g, group_size=m, ms=ms / calls,
                  plain_ms=plain_ms, draw_only_ms=draw_only, bound_ms=b, bound_by=by)
    emit("kernel_vs_plain", kernel="two_level_draw_rebuild", **fields)
    return fields


def coord_update_times(X, csc, y_t, pcsr, pcsc, runs, buckets, errs) -> dict:
    """``coord_update``'s device ms per launch over both main paths' columns
    (replayed in order), on each bucket's column and on a sweep of column
    lengths with each route forced (the threshold), against their bounds;
    returns its ``kernels`` entry."""
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    em = em_scale_for(FWConfig(backend="torch_sparse", queue="two_level", steps=T_MAIN), N)
    group_size = tl_init(setup[2].abs() * em).group_size
    gaps = torch.zeros(T_MAIN, device=DEVICE)
    cds = torch.zeros(T_MAIN, dtype=torch.int32, device=DEVICE)
    scratch = coord_update_scratch(N, D, DEVICE)

    def replay(fn, coords, private):
        """(device or host) ms per launch of ``fn`` over a run's columns, in order."""
        em_r = em if private else 1.0
        st = _state_copy(fw_carry_init(D, torch.float32, *setup, em_r, prng.PRNGKey(0),
                                       private=private))
        js = torch.from_numpy(coords.astype(np.int32)).to(DEVICE)
        extra = {"scratch": scratch} if fn is coord_update else {}
        launches = [
            (lambda i=i: fn(js[i:i + 1], pcsr, pcsc, None, st["w"], st["w_m"], st["g_tilde"],
                            st["vbar"], st["qbar"], st["alpha"], st["queue"],
                            **_step_kwargs(st, "logistic", em_r, gaps, cds, i, float(i + 1)),
                            **extra))
            for i in range(len(coords))]
        if fn is coord_update:
            return device_ms(launches)
        return sync_ms(lambda: [f() for f in launches]) / len(coords)

    coords = runs["private"]["res"].coords.cpu().numpy()
    ms = replay(coord_update, coords, True)
    plain = replay(coord_update_ref, coords, True)
    nbytes, ops = _coord_update_bytes(X, csc, coords, group_size)
    b, by = bound(nbytes, ops)
    carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0), private=True)
    nnz_all = np.diff(csc.indptr)
    short_max = short_route_max_rows()

    def bucket_times(j) -> dict:
        """Device ms per launch on column j, each route forced and the kernel's pick."""
        out = dict(column=int(j), col_nnz=int(nnz_all[j]),
                   route_auto="short" if nnz_all[j] <= short_max else "long",
                   bound_ms=bound(*_coord_update_bytes(X, csc, [j], group_size))[0])
        for route in ("auto", "short", "long"):
            st = _state_copy(carry)
            jt = torch.tensor([j], dtype=torch.int32, device=DEVICE)
            launch = lambda: coord_update(
                jt, pcsr, pcsc, None, st["w"], st["w_m"], st["g_tilde"], st["vbar"],
                st["qbar"], st["alpha"], st["queue"],
                **_step_kwargs(st, "logistic", em, gaps, cds, 0, 9.0), scratch=scratch,
                route=route)
            out[f"ms_{route}"] = device_ms([launch] * 10)
        return out

    by_bucket = {name: bucket_times(j) for name, j in buckets.items()}
    # the threshold: both routes on columns of growing length
    live = np.flatnonzero(nnz_all > 0)
    sweep = [bucket_times(int(live[np.argmin(np.abs(nnz_all[live] - target))]))
             for target in (2, 4, 8, 10, 12, 14, 16, 20, 24, 32, 64, 128, 256, 1024, 4096)]
    per_run = {}
    for name in ("private", "non_private"):
        cs = runs[name]["res"].coords.cpu().numpy()
        sel_nnz = nnz_all[cs]
        per_run[name] = dict(
            col_nnz_mean=float(sel_nnz.mean()), col_nnz_median=float(np.median(sel_nnz)),
            col_nnz_max=int(sel_nnz.max()), long_route_steps=int((sel_nnz > short_max).sum()),
            coord_update_ms=ms if name == "private" else replay(coord_update, cs, False),
            coord_update_bound_ms=bound(*_coord_update_bytes(X, csc, cs, group_size))[0])
    entry = dict(name="coord_update", route="cuda",
                 source="src/repro_torch/kernels/coord_update/csrc/coord_update.cu",
                 replaces="src/repro/kernels/coord_update/kernel.py:156",
                 launches=runs["private"]["counts"]["coord_update"],
                 max_abs_err=errs["coord_update"], ms=ms, plain_ms=plain, bound_ms=b,
                 bound_by=by, library_ms=None,
                 non_private_ms=per_run["non_private"]["coord_update_ms"],
                 non_private_launches=runs["non_private"]["counts"]["coord_update"],
                 non_private_bound_ms=per_run["non_private"]["coord_update_bound_ms"],
                 head_ms=by_bucket["head"]["ms_auto"])
    emit("kernel_times", coord_update_by_bucket=by_bucket, coord_update_sweep=sweep,
         coord_update_short_route_max_rows=short_max, coord_update_main_path=per_run)
    return entry


# ---------------------------------------------------------------------------
# the LM: flash attention, forward, serving, the DP-LASSO probe
# ---------------------------------------------------------------------------


def _qkv(b, s, h, kv, hd, dtype, seed):
    gen = torch.Generator(DEVICE).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def attention_ops(b, sq, sk, h, hd, causal, window) -> float:
    """Flops of the scores and P·V over the keys each query sees (2 per MAC)."""
    qpos = np.arange(sq)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    return 4.0 * b * h * hd * float(np.maximum(hi - lo, 0).sum())


def bf16_ulps(diff: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|d| in units of the bf16 spacing at max(|plain|, the row's RMS over hd)."""
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return diff / (torch.finfo(torch.bfloat16).eps * torch.maximum(ref.abs(), rms))


def phase_flash_vs_plain() -> dict:
    """Each route of the kernel (bf16: tensor cores, float32: CUDA cores)
    against the plain blockwise version (models/flash.py) on the card;
    returns the error at the LM forward's shape by dtype."""
    cfg = get_model(LM_ARCH).cfg
    lm = (LM_B, LM_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    cases = [(lm, torch.bfloat16, True, 0), (lm, torch.float32, True, 0),
             ((2, LM_S, 32, 4, 64), torch.float32, True, 300),       # local window
             ((2, 1024, 32, 4, 64), torch.bfloat16, False, 0),       # non-causal
             ((2, 1024, 16, 4, 128), torch.float32, True, 0),        # the other dense configs' hd
             ((1, 2048, 10, 1, 256), torch.bfloat16, True, 512)]     # recurrentgemma's hd, local
    err_lm = {}
    for shape, dtype, causal, window in cases:
        q, k, v = _qkv(*shape, dtype, seed=sum(shape))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        diff, ref = (got.float() - want.float()).abs(), want.float()
        err = float(diff.max())
        tol = FLASH_TOL[dtype]
        ok = bool((diff <= tol + tol * ref.abs()).all())
        ulps = None
        if dtype == torch.bfloat16:
            ulps = float(bf16_ulps(diff, ref).max())
            ok = ok and ulps <= FLASH_BF16_ULPS
        require(ok and bool(torch.isfinite(got).all()),
                f"flash_attention {shape} {dtype} causal={causal} window={window}: "
                f"max |d| {err} over tolerance {tol}, or {ulps} bf16 ulps of scale "
                f"over {FLASH_BF16_ULPS}")
        require(torch.equal(got, flash_attention(q, k, v, causal=causal, window=window)),
                "flash_attention is not deterministic")
        if shape == lm:
            err_lm[dtype] = err
        emit("flash_vs_plain", shape=list(shape), dtype=str(dtype).replace("torch.", ""),
             causal=causal, window=window, max_abs_err=err, tolerance=tol,
             tolerance_rule="|d| <= tol + tol * |plain|", deterministic=True,
             **({} if ulps is None else dict(
                 max_bf16_ulps_of_scale=ulps, bf16_ulps_bound=FLASH_BF16_ULPS,
                 scaled_rule="|d| <= 4 * 2^-7 * max(|plain|, RMS of the row over hd)")))
    return err_lm


class plain_attention:
    """Within the block, the model's attention runs the plain version on the
    card (the reference forward of the parity check)."""

    def __enter__(self):
        model_common.flash_attention = flash_attention_plain

    def __exit__(self, *exc):
        model_common.flash_attention = flash_attention


def phase_lm_forward():
    """Full-width tinyllama forward(last_only) at B x S: float32 parity of the
    kernel path against the plain path on the card, then bfloat16 timing."""
    stream = lm_batches(get_model(LM_ARCH).cfg.vocab, LM_B, LM_S, seed=1)
    tokens = torch.from_numpy(next(stream)["tokens"]).long().to(DEVICE)
    # ---- float32 parity ----------------------------------------------------
    api32 = get_model(LM_ARCH, overrides={"dtype": "float32"})
    t0 = time.perf_counter()
    p32 = api32.init(LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launch_counts()
    got = api32.forward(p32, tokens, last_only=True)
    require(launch_counts()["flash_attention"] == api32.cfg.n_layers, "f32 forward launches")
    f32_routes = dict(flash_attention.routes)
    require(f32_routes == {"bf16_tensor_cores": 0, "f32_cuda_cores": api32.cfg.n_layers},
            f"f32 forward routes {f32_routes}")
    reset_launch_counts()
    with plain_attention():
        want = api32.forward(p32, tokens, last_only=True)
    require(launch_counts()["flash_attention"] == 0, "the plain forward launched the kernel")
    require(got.shape == (LM_B, 1, api32.cfg.padded_vocab) and bool(torch.isfinite(got).all()),
            f"f32 logits {tuple(got.shape)} not finite or misshapen")
    d = float((got - want).abs().max())
    top_equal = bool((got.argmax(-1) == want.argmax(-1)).all())
    require(d <= LOGITS_ATOL and top_equal,
            f"f32 forward: kernel vs plain logits max |d| {d} (bound {LOGITS_ATOL}), "
            f"top-1 equal {top_equal}")
    emit("lm_forward", run="parity_float32", arch=LM_ARCH, batch=LM_B, seq=LM_S,
         params=sum(t.numel() for t in _leaves(p32)), init_s=init_s, max_abs_logit_err=d,
         bound=LOGITS_ATOL, top1_equal=True, logit_std=float(want.std()))
    # ---- bfloat16 timing -----------------------------------------------------
    api = get_model(LM_ARCH)
    params = api.init(LM_SEED)
    fwd = lambda: api.forward(params, tokens, last_only=True)
    out = fwd()                                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first_ms = sync_ms(fwd)
    counts = launch_counts()
    want_counts = {name: 0 for name in counts}
    want_counts["flash_attention"] = api.cfg.n_layers
    require(counts == want_counts, f"bf16 forward launches {counts}, expected {want_counts}")
    routes = dict(flash_attention.routes)
    require(routes == {"bf16_tensor_cores": api.cfg.n_layers, "f32_cuda_cores": 0},
            f"bf16 forward routes {routes}")
    peak = torch.cuda.max_memory_allocated()
    ms = sync_ms(fwd, reps=3)
    require(bool(torch.isfinite(out.float()).all()), "bf16 logits not finite")
    prof = profile_steps("lm_forward_bf16", 1, fwd)
    # both routes' kernels are named flash_fwd_*; the bf16 forward runs the mma one
    flash = {k: v for k, v in prof["by_kernel"].items() if "flash_fwd" in k}
    flash_dev = sum(flash.values())
    require(flash_dev > 0 and all("mma" in k for k in flash),
            f"bf16 forward: flash kernels in the profile {list(flash)}")
    flash_calls = sum(c for k, c in prof["calls"].items() if "flash_fwd" in k)
    require(flash_calls == api.cfg.n_layers, f"profiled flash launches {flash_calls}")
    emit("lm_forward", run="timing_bfloat16", arch=LM_ARCH, batch=LM_B, seq=LM_S,
         forward_ms=ms, first_forward_ms=first_ms, launches=counts, routes=routes,
         tokens_per_s=LM_B * LM_S / ms * 1e3, max_memory_allocated=peak,
         flash_device_ms=flash_dev, flash_profiled_calls=flash_calls,
         flash_share_of_forward=flash_dev / prof["wall_ms"])
    return api, params, api32, p32, routes, f32_routes


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_lm_serve(api, params, api32, p32) -> None:
    """The serving engine at full width (bf16), and decode == forward (f32)."""
    engine = ServingEngine(api, params, ServeConfig(slots=4, max_len=2048, prefill_bucket=64))
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)          # each ends in a host read of the logits
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    engine._prefill_into_slot = timed(engine._prefill_into_slot, "prefill")
    engine._step = timed(engine._step, "decode")
    rng = np.random.default_rng(7)
    for i in range(8):
        engine.submit(Request(uid=i, prompt=rng.integers(1, api.cfg.vocab, int(
            rng.integers(32, 65))).astype(np.int32), max_new_tokens=32))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    finished = engine.run()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    require(len(finished) == 8 and all(len(r.generated) == 32 for r in finished),
            "serving: not every request got its 32 tokens")
    require(all(0 <= t < api.cfg.padded_vocab for r in finished for t in r.generated),
            "serving: a token out of the vocabulary")
    gen = sum(len(r.generated) for r in finished)
    # where a batched decode step's time goes: 8 steps under the profiler
    toks = torch.ones(4, 1, dtype=torch.int64, device=DEVICE)
    pos = torch.full((4,), 100, dtype=torch.int64, device=DEVICE)
    prof = profile_steps("lm_decode_bf16", 8, lambda: [
        api.decode_step(params, engine.cache, toks, pos) for _ in range(8)])
    kernels_per_step = sum(prof["calls"].values()) / 8
    # decode == forward at full width in float32: the kernel forward's last
    # logits against decode steps over the same prompt
    toks = torch.from_numpy(rng.integers(1, api32.cfg.vocab, (2, 64))).to(DEVICE)
    full = api32.forward(p32, toks, last_only=True)
    cache = api32.init_cache(2, 128)
    for t in range(toks.shape[1]):
        logits, cache = api32.decode_step(p32, cache, toks[:, t:t + 1], t)
    d = float((logits - full).abs().max())
    require(d <= LOGITS_ATOL, f"decode vs forward (f32) max |d| {d} over {LOGITS_ATOL}")
    emit("lm_serve", arch=LM_ARCH, slots=4, max_len=2048, requests=8, new_tokens=32,
         prefill_bucket=64, wall_s=wall, generated_tokens=gen, tokens_per_s=gen / wall,
         decode_steps=engine.steps, decode_step_ms=float(np.mean(times["decode"])) * 1e3,
         prefills=engine.prefills, prefill_ms=float(np.mean(times["prefill"])) * 1e3,
         launches=counts, max_memory_allocated=torch.cuda.max_memory_allocated(),
         device_kernels_per_decode_step=kernels_per_step,
         decode_vs_forward_f32_max_abs=d, bound=LOGITS_ATOL)


def phase_lm_probe(api, params) -> None:
    """examples/dp_lasso_probe.py's pipeline on the full-width bf16 backbone."""
    t = {}
    t0 = time.perf_counter()
    tokens = torch.from_numpy(next(lm_batches(api.cfg.vocab, PROBE_ROWS, PROBE_SEQ,
                                              seed=1))["tokens"]).long().to(DEVICE)
    t["tokens_s"] = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    hidden = api.forward(params, tokens, last_only=True)[:, 0, :256].float()
    torch.cuda.synchronize()
    t["backbone_s"] = time.perf_counter() - t0
    require(launch_counts()["flash_attention"] == api.cfg.n_layers, "probe backbone launches")
    t0 = time.perf_counter()
    gen = torch.Generator(DEVICE).manual_seed(2)
    proj = torch.randn(hidden.shape[1], PROBE_FEATURES, generator=gen, device=DEVICE) / 16.0
    expanded = torch.relu(hidden @ proj)
    thresh = torch.quantile(expanded, 0.95)                # keep ~5% of entries
    X = dense_to_host(torch.where(expanded > thresh, expanded, 0.0).cpu().numpy())
    t["expansion_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    w_star = np.zeros(PROBE_FEATURES)
    w_star[rng.choice(PROBE_FEATURES, 32, replace=False)] = rng.normal(0, 2, 32)
    dense = X.to_dense()
    margins = dense @ w_star
    y = (margins > np.median(margins)).astype(np.float64)
    cfg = FWConfig(backend="torch_sparse", queue="two_level", lam=20.0, steps=PROBE_T,
                   epsilon=1.0, delta=1.0 / PROBE_ROWS ** 2, device=DEVICE)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(X, y, cfg)
    torch.cuda.synchronize()
    t["solve_s"] = time.perf_counter() - t0
    counts = launch_counts()
    require(counts["coord_update"] == PROBE_T and counts["two_level_draw"] == PROBE_T,
            f"probe solve launches {counts}")
    w = res.w.cpu().numpy().astype(np.float64)
    acc = float(((dense @ w > 0) == (y > 0.5)).mean())
    require(acc > 0.55, f"probe accuracy {acc} <= 0.55")
    emit("lm_probe", arch=LM_ARCH, rows=PROBE_ROWS, seq=PROBE_SEQ, features=PROBE_FEATURES,
         design_nnz=int(X.nnz), density=X.nnz / (PROBE_ROWS * PROBE_FEATURES), steps=PROBE_T,
         lam=20.0, epsilon=1.0, accuracy=acc, nnz_w=int((w != 0).sum()), launches=counts,
         **t)


def flash_kernel_times(routes: dict, f32_routes: dict, errs: dict) -> list:
    """Each route of the kernel at the LM forward's shape, in its dtype,
    against its bound, the plain version and SDPA; ``launches`` is the
    route's count in the forward of that dtype."""
    cfg = get_model(LM_ARCH).cfg
    b, s, h, kv, hd = LM_B, LM_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ops = attention_ops(b, s, s, h, hd, True, 0)
    rows = []
    for dtype, name, source, launches, peak in (
            (torch.bfloat16, "flash_attention", "flash_attention_mma.cu",
             routes["bf16_tensor_cores"], BF16_OPS_PER_S),
            (torch.float32, "flash_attention_f32", "flash_attention.cu",
             f32_routes["f32_cuda_cores"], F32_OPS_PER_S)):
        q, k, v = _qkv(b, s, h, kv, hd, dtype, seed=11)
        ms = device_ms([lambda: flash_attention(q, k, v, causal=True)] * 10)
        plain = device_ms([lambda: flash_attention_plain(q, k, v, causal=True)] * 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_out = sdpa().transpose(1, 2)
        # a sanity check of the yardstick, which sums in its own order
        tol = 0.06 if dtype == torch.bfloat16 else 1e-4
        require(bool(((lib_out.float() - flash_attention(q, k, v).float()).abs() <= tol).all()),
                f"scaled_dot_product_attention disagrees with {name}")
        lib = device_ms([sdpa] * 10)
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + q.numel())
        bd, by = bound(nbytes, ops, peak)
        rows.append(dict(name=name, route="cuda",
                         source=f"src/repro_torch/kernels/flash_attention/csrc/{source}",
                         replaces="src/repro/kernels/flash_attention/kernel.py:106",
                         launches=launches, max_abs_err=errs[dtype], ms=ms, plain_ms=plain,
                         bound_ms=bd, bound_by=by, library_ms=lib, tflop_per_s=ops / ms / 1e9))
        del q, k, v, qt, kt, vt, lib_out
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    X, csc, y, pcsr, pcsc, col_nnz = phase_data()
    y_t = torch.from_numpy(y.astype(np.float32)).to(DEVICE)
    buckets = column_buckets(col_nnz)
    errs = phase_kernels_vs_plain(y_t, pcsr, pcsc, buckets, col_nnz)
    runs = phase_main_path(pcsr, pcsc, y)
    alg1 = phase_alg1(pcsr, pcsc, y)
    alg2_step, window = phase_step_times(pcsr, pcsc, y_t)
    alg1_step, share = phase_alg1_step_times(pcsr, pcsc, y_t)
    emit("alg1_vs_alg2", steps=T_MAIN, per_step_ms={
        **{f"dense_{k}": v for k, v in alg1_step.items()},
        **{f"torch_sparse_{k}": v for k, v in alg2_step.items()}},
        solve_s={**{f"dense_{k}": v["wall"] for k, v in alg1.items()},
                 **{f"torch_sparse_{k}": v["wall"] for k, v in runs.items()}},
        alg1_argmax_share_of_step=share)
    phase_parity(X, y, pcsr, pcsc, col_nnz)
    phase_duplicates(X, csc, y, y_t, buckets)
    phase_gap_tol(pcsr, pcsc, y, runs, alg1)
    kernels = phase_kernel_times(X, csc, y_t, pcsr, pcsc, runs, alg1, buckets, errs, share,
                                 window)
    del X, csc, pcsr, pcsc, runs, alg1
    torch.cuda.empty_cache()
    flash_errs = phase_flash_vs_plain()
    api, params, api32, p32, routes, f32_routes = phase_lm_forward()
    phase_lm_serve(api, params, api32, p32)
    del p32
    phase_lm_probe(api, params)
    kernels.extend(flash_kernel_times(routes, f32_routes, flash_errs))
    emit("done", seconds=time.perf_counter() - t_start)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
