#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py        # from the repository root; needs one card

It builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version on the card, and drives
the port's two paths through ``repro_torch.solve`` at the full size of
LIBSVM's rcv1.binary training set (N = 20,242 rows, D = 47,236 features,
~74 nnz per row, made from seed 0 by the port's synthetic generator):

* Alg 2, backend ``torch_sparse``, private and non-private;
* Alg 1, backend ``dense``, for the ``argmax``, ``gumbel`` and
  ``noisy_max`` rules on the padded pair, and on the dense (N, D) matrix;
* both with ``gap_tol`` early stopping (the chunk loop ``drive_chunks``).

It holds the card's runs against CPU runs of the plain versions and the
stopped runs against the fixed-T runs.  Phases print one JSON line each and
raise on any failure (non-zero exit).  The last three lines are the card's
name and power limit as ``nvidia-smi`` reports them, the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.

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
from repro_torch.core.samplers.two_level import tl_init, tl_rebuild_  # noqa: E402
from repro_torch.core.solvers.torch_sparse import (em_scale_for, fw_carry_init,  # noqa: E402
                                                   fw_scan_chunk, fw_setup)
from repro_torch.core.sparse.formats import host_to_padded, tiered_from_padded  # noqa: E402
from repro_torch.data.synthetic import make_sparse_classification  # noqa: E402
from repro_torch.kernels import _lib, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bsls_draw import two_level_draw  # noqa: E402
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref  # noqa: E402
from repro_torch.kernels.coord_update import coord_update  # noqa: E402
from repro_torch.kernels.coord_update.ref import coord_update_ref  # noqa: E402
from repro_torch.kernels.spmv import ell_matvec, ell_rmatvec  # noqa: E402
from repro_torch.kernels.spmv.ref import ell_matvec_ref, ell_rmatvec_ref  # noqa: E402

# rcv1.binary training set (LIBSVM): rows, features, nnz per row
N, D, NNZ_PER_ROW, INFORMATIVE, SEED = 20242, 47236, 74, 64, 0
LAM, T_MAIN, T_PARITY, WARMUP = 50.0, 500, 200, 50
LOSSES = ("logistic", "squared", "lad", "huber", "smoothed_hinge")
SELECTIONS = ("argmax", "gumbel", "noisy_max")
# H100 SXM datasheet peaks: HBM bytes/s, float32 outside tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
DEVICE = "cuda"


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


def bound(nbytes: float, ops: float) -> tuple:
    """(bound ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
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
    return dict(t=t, lam=LAM, inv_n=1.0 / N, em_scale=em, loss=loss, gaps=gaps,
                coords=coords, slot=slot)


def _run_update(fn, j, pcsr, pcsc, y, st, loss, em, gaps, coords, slot, t=7.0):
    fn(j, pcsr, pcsc, y, st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"],
       st["alpha"], st["queue"], **_step_kwargs(st, loss, em, gaps, coords, slot, t))
    if hasattr(st["queue"], "c"):
        tl_rebuild_(st["queue"])


def phase_kernels_vs_plain(y_t, pcsr, pcsc, buckets, col_nnz) -> dict:
    """Each kernel against its plain version on the card, at the main path's shapes."""
    errs = {}
    # ---- ell_rmatvec: Xᵀq at 20,242 × 111 → 47,236 ------------------------
    q = torch.from_numpy(np.random.default_rng(1).normal(size=N).astype(np.float32)).to(DEVICE)
    got = ell_rmatvec(pcsr, q, pcsc)
    again = ell_rmatvec(pcsr, q, pcsc)
    ref = ell_rmatvec_ref(pcsr.indices, pcsr.values, q, D)
    # float32 sums of up to 20,242 terms in two orders: |Δ| within 1e-5 of Σ|terms|
    scale = ell_rmatvec_ref(pcsr.indices, pcsr.values.abs(), q.abs(), D)
    err = (got - ref).abs()
    require(bool((err <= 1e-5 * scale + 1e-7).all()), "ell_rmatvec disagrees with plain")
    require(torch.equal(got, again), "ell_rmatvec is not deterministic")
    errs["ell_rmatvec"] = float(err.max())
    emit("kernel_vs_plain", kernel="ell_rmatvec", max_abs_err=errs["ell_rmatvec"],
         tolerance="|d| <= 1e-5 * sum|terms| + 1e-7 per column", deterministic=True)

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
    errs["ell_matvec"] = worst
    emit("kernel_vs_plain", kernel="ell_matvec", max_abs_err=worst,
         tolerance="|d| <= 1e-5 * sum|terms| + 1e-7 per row", deterministic=True)

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
    emit("kernel_vs_plain", kernel="coord_update", max_abs_err=worst, columns=buckets,
         col_nnz={k: int(col_nnz[v]) for k, v in buckets.items()},
         tolerance="allclose rtol 1e-5 atol 1e-6, every output, 5 losses x 2 queues x 3 columns")

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


def duality_gap(pcsr, y, w) -> float:
    """FW duality gap of the logistic objective at w: ⟨w, ∇f⟩ + λ‖∇f‖∞ (plain ops)."""
    r = torch.sigmoid(pcsr.matvec(w)) - torch.from_numpy(y.astype(np.float32)).to(w.device)
    grad = ell_rmatvec_ref(pcsr.indices, pcsr.values, r, D) / N
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
                "ell_rmatvec": 2, "ell_matvec": 0}
        require(counts == want, f"launch counts {counts}, expected {want}")
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
             solve_s=wall, launches=counts, gap_first=float(gaps[0]),
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
    profile_steps("private", 100, lambda: fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0,
                                                         WARMUP, None, steps=100, **kw))
    return per_step


def profile_steps(run: str, steps: int, window) -> dict:
    """Device time by kernel over ``window()``, a run of ``steps`` steps
    (torch.profiler); returns the device ms by kernel name."""
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
    emit("profile", run=run, steps=steps, wall_ms_profiled=wall_ms,
         device_busy_ms=busy_ms if by_kernel else None,
         device_idle_share=(1.0 - busy_ms / wall_ms) if by_kernel else None,
         top_device=[{"name": k[:80], "ms": ms, "calls": c} for k, ms, c in by_kernel[:8]],
         note=None if by_kernel else "the profiler recorded no device time")
    return {"wall_ms": wall_ms, "by_kernel": {k: ms for k, ms, _ in by_kernel}}


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
                "two_level_draw": 0}
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


def phase_kernel_times(X, csc, y_t, pcsr, pcsc, runs, alg1, buckets, errs) -> list:
    """Times of each kernel at the main paths' shapes, against its bound.
    ``launches``: the Alg 1 argmax solve's count for the spmv kernels, the
    private Alg 2 solve's for the others (each phase line has every run's)."""
    kernels = []
    # ---- ell_rmatvec --------------------------------------------------------
    q = torch.from_numpy(np.random.default_rng(2).normal(size=N).astype(np.float32)).to(DEVICE)
    ms = device_ms([lambda: ell_rmatvec(pcsr, q, pcsc)] * 20)
    plain = device_ms([lambda: ell_rmatvec_ref(pcsr.indices, pcsr.values, q, D)] * 20)
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
                        bound_by=by, library_ms=lib))
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
    b, by = bound(8.0 * X.nnz + 8.0 * N + 4.0 * D, 2.0 * X.nnz)
    kernels.append(dict(name="ell_matvec", route="cuda",
                        source="src/repro_torch/kernels/spmv/csrc/ell_matvec.cu",
                        replaces="src/repro/kernels/spmv/kernel.py:55",
                        launches=alg1["argmax"]["counts"]["ell_matvec"],
                        max_abs_err=errs["ell_matvec"], ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=lib))
    # ---- two_level_draw -------------------------------------------------------
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    em = em_scale_for(FWConfig(backend="torch_sparse", queue="two_level", steps=T_MAIN), N)
    state = tl_init(setup[2].abs() * em)
    _, keys = prng.key_chain(prng.PRNGKey(5), 1000)
    out = torch.empty(1, dtype=torch.int32, device=DEVICE)
    ms = device_ms([lambda k=k: two_level_draw(state.c, state.v, k, out=out) for k in keys])
    plain = sync_ms(lambda: [two_level_draw_ref(state.c, state.v, k) for k in keys[:200]]) / 200
    g, m = state.v.shape
    b, by = bound(4.0 * (g + m) + 4.0, 125.0 * (g + m) + 230.0)
    kernels.append(dict(name="two_level_draw", route="cuda",
                        source="src/repro_torch/kernels/bsls_draw/csrc/two_level_draw.cu",
                        replaces="src/repro/kernels/bsls_draw/kernel.py:62",
                        launches=runs["private"]["counts"]["two_level_draw"],
                        max_abs_err=errs["two_level_draw"], ms=ms, plain_ms=plain,
                        bound_ms=b, bound_by=by, library_ms=None))
    # ---- coord_update: replay the private main path's columns -----------------
    gaps = torch.zeros(T_MAIN, device=DEVICE)
    cds = torch.zeros(T_MAIN, dtype=torch.int32, device=DEVICE)
    scratch = torch.empty(N, device=DEVICE)

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
    nbytes, ops = _coord_update_bytes(X, csc, coords, state.group_size)
    b, by = bound(nbytes, ops)
    carry = fw_carry_init(D, torch.float32, *setup, em, prng.PRNGKey(0), private=True)
    by_bucket = {}
    for name, j in buckets.items():
        st = _state_copy(carry)
        jt = torch.tensor([j], dtype=torch.int32, device=DEVICE)
        launch = lambda: coord_update(jt, pcsr, pcsc, None, st["w"], st["w_m"], st["g_tilde"],
                                      st["vbar"], st["qbar"], st["alpha"], st["queue"],
                                      **_step_kwargs(st, "logistic", em, gaps, cds, 0, 9.0),
                                      scratch=scratch)
        bb, _ = bound(*_coord_update_bytes(X, csc, [j], state.group_size))
        by_bucket[name] = dict(column=j, col_nnz=int(csc.indptr[j + 1] - csc.indptr[j]),
                               ms=device_ms([launch] * 10), bound_ms=bb)
    kernels.append(dict(name="coord_update", route="cuda",
                        source="src/repro_torch/kernels/coord_update/csrc/coord_update.cu",
                        replaces="src/repro/kernels/coord_update/kernel.py:156",
                        launches=runs["private"]["counts"]["coord_update"],
                        max_abs_err=errs["coord_update"], ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=None))
    per_run = {}
    for name in ("private", "non_private"):
        cs = runs[name]["res"].coords.cpu().numpy()
        sel_nnz = np.diff(csc.indptr)[cs]
        per_run[name] = dict(
            col_nnz_mean=float(sel_nnz.mean()), col_nnz_median=float(np.median(sel_nnz)),
            col_nnz_max=int(sel_nnz.max()),
            coord_update_ms=ms if name == "private" else replay(coord_update, cs, False),
            coord_update_bound_ms=bound(*_coord_update_bytes(X, csc, cs, state.group_size))[0])
    emit("kernel_times", coord_update_by_bucket=by_bucket, coord_update_main_path=per_run)
    return kernels


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
    alg2_step = phase_step_times(pcsr, pcsc, y_t)
    alg1_step, share = phase_alg1_step_times(pcsr, pcsc, y_t)
    emit("alg1_vs_alg2", steps=T_MAIN, per_step_ms={
        **{f"dense_{k}": v for k, v in alg1_step.items()},
        **{f"torch_sparse_{k}": v for k, v in alg2_step.items()}},
        solve_s={**{f"dense_{k}": v["wall"] for k, v in alg1.items()},
                 **{f"torch_sparse_{k}": v["wall"] for k, v in runs.items()}},
        alg1_argmax_share_of_step=share)
    phase_parity(X, y, pcsr, pcsc, col_nnz)
    phase_gap_tol(pcsr, pcsc, y, runs, alg1)
    kernels = phase_kernel_times(X, csc, y_t, pcsr, pcsc, runs, alg1, buckets, errs)
    emit("done", seconds=time.perf_counter() - t_start)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
