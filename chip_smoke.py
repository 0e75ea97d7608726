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
* both with ``gap_tol`` early stopping (the chunk loop ``drive_chunks``);
* both with DP screening (``screen_every=1``, 8 rounds: the pair repacked on
  the card), against the unscreened runs, the CPU's and forced keep-all
  rounds, and the kernels timed on the survivors' pair (``screen``);
* ``solve_path`` over λ = 50, 30, 20, 10 (both, against cold solves of the
  segments) and a private path group of 8 configs as lanes and
  sequentially (``path``);
* Alg 2's other engines: ``torch_dense`` (``backend="jax_dense"``, dense
  vector updates in torch ops, its scatter-adds in input order) against
  ``torch_sparse`` and the CPU, both tiles timed (``engines``); the eager
  oracle ``reference_fw`` (``reference``); ``host_sparse``'s float64 host
  loop (``host_sparse``);
* a ``FitService`` on the matrix: three tenants, a private grid of 8 as one
  lane batch, non-private fits on three backends, a ``gap_tol`` fit, two
  refusals charged nothing (``fit_service``);
* the sharded engine ``jax_shard`` on a 1×1 grid under an NCCL process
  group of one rank, T = 500, private and non-private, against its CPU run,
  its oracle ``distributed/reference.py`` and ``torch_sparse``
  (``shard_1x1``); the in-order scatter kernel ``scatter_add_ordered`` at
  three shapes against its plain version on the CPU, bit for bit
  (``scatter_vs_plain``); flash attention at head dims outside its table
  (``flash_head_dims``); and ``jax_shard`` on a 2×2 grid, four processes on
  the card over gloo at a cut size, against the same grid on the CPU
  (``shard_2x2_gloo``).

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
Then it writes the matrix as LIBSVM text, ingests it into a dataset store
(``repro_torch.data``), and solves from the store cold (padded and setup
caches written) and warm (replayed): Alg 2 private and non-private and
Alg 1 ``argmax`` on the dense form, each equal to its in-memory run bit for
bit (``store``; it needs ~7.8 GB free under the temp directory and
removes what it wrote).
Then it drives the LM at the full published width of ``tinyllama-1.1b``
(22 layers, d_model 2048, 32 heads, 4 KV heads, random weights from a seed):

* ``forward`` (``last_only``) at B = 4 × S = 2,048 through the flash-attention
  kernel, held in float32 (its CUDA-core route) against the same forward
  with the plain attention, and timed in bfloat16 (its tensor-core route);
* the serving engine (4 slots, 8 requests, greedy), and decode ≡ forward;
* ``examples/dp_lasso_probe.py``'s pipeline: backbone features, a random-ReLU
  expansion and a private ``torch_sparse`` solve on them.

Last (``lm_archs``), alone on the card, the eight other archs at their
published widths, one after another: ``minicpm-2b``, ``nemotron-4-15b`` and
``chameleon-34b`` at full depth, ``deepseek-v2-236b`` (MLA, MoE) and
``kimi-k2-1t-a32b`` (MoE) cut in depth to fit the card (each line lists its
cuts under ``reduced``), then at full depth ``falcon-mamba-7b`` (the selective
SSM, no attention), ``recurrentgemma-2b`` (RG-LRU and local attention, window
2,048 over S = 4,096) and ``seamless-m4t-medium`` (encoder-decoder): a
float32 forward at a cut depth through the kernel held against the plain
forward (logits, top-1, every token's experts; mamba, with no kernel, against
the CPU; seamless with 1,024 frames against 512 tokens) and decode ≡ forward
(seamless after ``prefill_cross``); for mamba and rglru the float32 engine's
tokens, one request more than slots, equal to one-request greedy decodes; a
bf16 forward timed and profiled (flash, the expert products, dispatch and
combine, mamba's scan alone); the serving engine (seamless: prefill_cross and
decode steps timed, no engine serves it); and flash against SDPA at MLA's
(192, 128) and kimi-k2's 112 head dims, recurrentgemma's window and
seamless' cross-attention (1,024 tokens against 1,536 frames), each at its
arch's forward shape.

Last (``lm_train``), training on the card: flash attention's backward kernel
(``flash_attention_bwd.cu``) against its plain version at tinyllama's
training shape (bf16 and float32), MLA's (192, 128), kimi-k2's 112,
recurrentgemma's window and seamless' cross-attention, timed against its
bound, the plain version and SDPA's backward; ``tinyllama-1.1b`` at full
width and depth trained 30 steps of 8 × 2,048 tokens in bf16 with adamw
through ``launch.train.train_lm`` (the loss must fall 0.3 nats; 3 steps
profiled); a float32 step at 2 of 22 layers on the card against the CPU;
a checkpoint resume equal to the straight run; deepseek-v2 (adafactor,
capacity factor 1.25), kimi-k2, falcon-mamba, recurrentgemma and seamless
at full width and a cut depth, two steps each; and
``launch.train.train_lasso`` at rcv1's shape against ``solve``.

Phases print one JSON line each and raise on any failure (non-zero exit).
The last three lines are the card's name and power limit as ``nvidia-smi``
reports them, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import (FWConfig, FWResult, grid, obs, plan_for, prng, solve,  # noqa: E402
                         solve_many)
from repro_torch.core.fw_dense import _carry0, _dense_chunk, _dense_step  # noqa: E402
from repro_torch.core.samplers.group_argmax import ga_get_next, ga_init  # noqa: E402
from repro_torch.core import fw_dense  # noqa: E402
from repro_torch.core.samplers.two_level import (rebuild_groups_, tl_init,  # noqa: E402
                                                 tl_rebuild_, tl_scatter_)
from repro_torch.core.solvers import planner, screening, solve_path  # noqa: E402
from repro_torch.core.solvers.path import segment_config  # noqa: E402
from repro_torch.core.solvers.autotune import autotune  # noqa: E402
from repro_torch.core.dp.accountant import PrivacyAccountant  # noqa: E402
from repro_torch.core.fw_sparse import sparse_fw  # noqa: E402
from repro_torch.core.fw_torch import TILES, default_tile, sparse_fw_torch  # noqa: E402
from repro_torch.core.solvers.reference import reference_fw  # noqa: E402
from repro_torch.core.solvers.torch_sparse import (em_scale_for, fw_carry_init,  # noqa: E402
                                                   fw_carry_init_lanes, fw_scan_chunk,
                                                   fw_scan_chunk_lanes, fw_setup)
from repro_torch.core.sparse.formats import (HostCSR, PaddedCSR, dense_to_host,  # noqa: E402
                                             host_to_padded, tiered_from_padded)
from repro_torch.data.sparse_io import iter_libsvm, write_libsvm  # noqa: E402
from repro_torch.data.store import DatasetStore  # noqa: E402
from repro_torch.data.synthetic import (lm_batches, make_sparse_classification,  # noqa: E402
                                        with_repeated_entries)
from repro_torch.kernels import _lib, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bsls_draw import two_level_draw, two_level_draw_lanes  # noqa: E402
from repro_torch.kernels.bsls_draw.ops import arrival_counter, key_table, launch_floor  # noqa: E402
from repro_torch.kernels.bsls_draw.ref import (two_level_draw_lanes_ref,  # noqa: E402
                                               two_level_draw_ref)
from repro_torch.kernels.coord_update import coord_update, coord_update_lanes  # noqa: E402
from repro_torch.kernels.coord_update.ops import (coord_update_scratch, lane_scalars,  # noqa: E402
                                                  owner_table, scratch_bytes,
                                                  short_route_max_rows)
from repro_torch.kernels.coord_update.ref import (bitwise_rule_mismatches,  # noqa: E402
                                                  coord_update_lanes_ref, coord_update_ref,
                                                  same_bits)
from repro_torch.kernels.spmv import ell_matvec, ell_rmatvec  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_bwd, flash_attention_with_lse)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import pad_head_dims, padded_head_dim  # noqa: E402
from repro_torch.kernels.scatter import scatter_add_ordered  # noqa: E402
from repro_torch.kernels.scatter.ref import scatter_add_ordered_ref  # noqa: E402
from repro_torch.core.solvers.jax_shard import shard_em_scale  # noqa: E402
from repro_torch.distributed.collectives import make_mesh  # noqa: E402
from repro_torch.distributed.fw_shard import (DistFWConfig, distributed_fw,  # noqa: E402
                                              shard_scan, shard_setup)
from repro_torch.distributed.ingest import ShardSource  # noqa: E402
from repro_torch.distributed import reference as shard_reference  # noqa: E402
from repro_torch.launch.shard import free_port, run_ranks, solve_rank  # noqa: E402
from repro_torch.kernels.spmv.ref import SEGMENT, ell_matvec_ref, ell_rmatvec_ref, segments  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import encdec, mamba  # noqa: E402
from repro_torch.models.flash import _flash_bwd  # noqa: E402
from repro_torch.models.flash import flash_attention as flash_attention_plain  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve import FitRequest, FitService, FitServiceConfig  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402

# rcv1.binary training set (LIBSVM): rows, features, nnz per row
N, D, NNZ_PER_ROW, INFORMATIVE, SEED = 20242, 47236, 74, 64, 0
LAM, T_MAIN, T_PARITY, WARMUP = 50.0, 500, 200, 50
T_DUP, DRAW_STEPS = 50, 1000    # the repeated-entries runs; the rebuilding draw's replay
# the sweep: a private grid of λ × ε (B = 8) and a non-private grid of λ (B = 4);
# the lane kernels are timed at B = 1, 4 and 8
SWEEP_LAMS, SWEEP_EPS, LANE_WIDTHS, LANE_STEPS = (10.0, 20.0, 30.0, 50.0), (0.5, 1.0), \
    (1, 4, 8), 200
STORE_ROWS_PER_SHARD = (4096, 7000)   # the store phase's two shard sizes
# screening: gap_tol's chunk, so T = 500 runs 9 chunks and screen_every=1 fires 8 rounds;
# λ-paths: budgets 500, 125, 125, 125 at T = 500; the path group: ε × seeds (B = 8)
SCREEN_CHUNK = 62
PATH_LAMS, PATH_GROUP_EPS, PATH_GROUP_SEEDS = (50.0, 30.0, 20.0, 10.0), (0.5, 1.0), \
    (0, 1, 2, 3)
SCREEN_RUNS = {"torch_sparse_private": dict(backend="torch_sparse", queue="two_level"),
               "torch_sparse_non_private": dict(backend="torch_sparse", queue="group_argmax"),
               "alg1_argmax": dict(backend="dense", selection="argmax"),
               "alg1_gumbel": dict(backend="dense", selection="gumbel")}
# the other engines and the fit service: host_sparse's T (its fib_heap queue
# updates each touched coordinate in Python); the service's three tenants' budgets
T_HOST = 500
# engines that round α differently (host_sparse in float64; jax_shard's α₀ as one fused
# Xᵀ((q̄ − y)/n) against Xᵀq̄/n − Xᵀy/n) may leave torch_sparse's coordinates only where its
# two picks tie within this relative margin (about 1,700 float32 spacings; set at 10x
# the first such tie seen, 1.01e-5)
TIE_REL = 1e-4
SVC_BUDGETS = {"acme": (8.0, T_MAIN), "globex": (1.0, T_MAIN),   # (ε, pool steps), δ = 1e-6
               "initech": (1.0, T_MAIN)}
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
# flash head dims outside the kernel's table: (hd, hdv) of minicpm-2b's and
# nemotron-4-15b's smoke widths, kimi-k2's, and MLA's q·k against v
FLASH_PAD_DIMS = ((18, 18), (24, 24), (112, 112), (192, 128))
# the lm_archs phase: the other archs at their published widths, in this order, after
# every other phase; each arch's bf16 timing run: prefill B x S (seamless: S decoder
# tokens against ENCDEC_TIMING_FRAMES encoder frames) and the depth (None:
# every layer; deepseek-v2-236b: its dense layer and 4 of its 59 MoE layers, 34.5 GB;
# kimi-k2-1t-a32b: its dense layer and 1 of its 60 MoE layers, 39.9 GB); recurrentgemma at
# S = 4,096, so that its 2,048 window masks
LM_ARCHS = {"minicpm-2b": (4, 2048, None), "nemotron-4-15b": (4, 2048, None),
            "chameleon-34b": (4, 2048, None), "deepseek-v2-236b": (1, 2048, 5),
            "kimi-k2-1t-a32b": (1, 1024, 2), "falcon-mamba-7b": (2, 2048, None),
            "recurrentgemma-2b": (2, 4096, None), "seamless-m4t-medium": (4, 1024, None)}
# float32 parity: two layers (an MoE arch's dense one and one MoE layer) on B x S
# tokens, decode == forward over the first ARCH_DECODE of them; kimi-k2's MoE layer is
# 67.8 GB in float32, so its float32 run keeps 64 of its 384 experts (top-8 kept);
# recurrentgemma keeps three layers (r, r, a: one local-attention layer) at B = 1 x S =
# 4,096; seamless two encoder and two decoder layers, ENCDEC_F32_FRAMES frames against
# the S decoder tokens, so that cross-attention runs with q and k of different lengths (a
# multiple of the plain version's 512-row q block, which the encoder's frames are)
ARCH_F32_B, ARCH_F32_S, ARCH_F32_LAYERS, ARCH_DECODE = 2, 512, 2, 32
ARCH_F32_OVERRIDES = {"kimi-k2-1t-a32b": {"n_experts": 64},
                      "recurrentgemma-2b": {"n_layers": 3},
                      "seamless-m4t-medium": {"n_layers": 4, "enc_layers": 2, "dec_layers": 2}}
ARCH_F32_SHAPE = {"recurrentgemma-2b": (1, 4096)}
ENCDEC_F32_FRAMES = 1024
# seamless' bf16 timing forward: more frames than tokens (speech frames outnumber the
# text they carry), whole 512-row blocks, so that its cross-attention has S_q != S_k
ENCDEC_TIMING_FRAMES = 1536
# prefill_cross + decode against the teacher-forced forward: the JAX package's bound
# (tests/test_serve.py)
ENCDEC_DECODE_ATOL = 5e-4
# the float32 kernel and plain forwards may send a token to other experts only where its
# k-th and (k+1)-th router probabilities tie within this relative margin (set before the
# first run, as TIE_REL: ~100x the router logits' difference that the kernel's float32
# attention error, <= 4.03e-7 at these head dims, could make)
ROUTE_TIE_REL = 1e-4
# serving each arch: slots, max_len, requests, prompt lengths, new tokens;
# the recurrent families serve one request more than slots (a slot reused), and their
# tokens are held, in float32 at the parity depth, to one-request greedy decodes
ARCH_SLOTS, ARCH_MAX_LEN, ARCH_REQUESTS, ARCH_PROMPT, ARCH_NEW = 4, 512, 4, (16, 32), 16
RECURRENT_FAMILIES = ("ssm", "hybrid")
# seamless has no engine: prefill_cross on ENCDEC_FRAMES frames a row (ARCH_SLOTS rows),
# then ENCDEC_STEPS greedy decode steps, timed
ENCDEC_FRAMES, ENCDEC_STEPS = 512, 48
# the sharded engine on a 2x2 grid over gloo: the rcv1.binary generator cut to fit
# four processes on one card and a CPU replay of the same grid in the time limit
SHARD2_N, SHARD2_D, SHARD2_T = 4096, 8192, 200
# the error-feedback top-k α exchange at the full width (distributed_fw only):
# k kept lanes, T steps, private
TOPK_K, TOPK_T = 8, 100


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
    pad_s = time.perf_counter() - t0
    csc = X.tocsc()
    col_nnz = np.diff(csc.indptr)
    emit("data", n=N, d=D, nnz=X.nnz, max_row_nnz=int(np.diff(X.indptr).max()),
         max_col_nnz=int(col_nnz.max()), p99_col_nnz=int(np.percentile(col_nnz, 99)),
         cols_over_1024=int((col_nnz > 1024).sum()),
         padded_csc_bytes=pcsc.indices.numel() * 8, padded_csr_bytes=pcsr.indices.numel() * 8,
         generate_s=t_gen, pad_on_card_s=pad_s)
    return X, csc, y, pcsr, pcsc, col_nnz, pad_s


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


def coord_update_bitwise(y_t, pcsr, pcsc, buckets, losses=LOSSES) -> dict:
    """The kernel's bitwise rule against the CPU on each bucket's column, each
    of ``losses``, both queues; the short and the long route forced on the
    same column give the same bits, and so does a rerun.  Returns the route
    each bucket took (from the kernel's own route counters)."""
    cpu_csr, cpu_cols, y_cpu = pcsr.to("cpu"), _ColumnsOnCPU(pcsc), y_t.cpu()
    n, d = pcsr.shape
    scratch = coord_update_scratch(n, d, DEVICE)
    taken = {}
    for loss in losses:
        setup = fw_setup(pcsr, y_t, loss=loss, pcsc=pcsc)
        for private in (False, True):
            em = 30.0 if private else 1.0
            carry = fw_carry_init(d, torch.float32, *setup, em, prng.PRNGKey(0),
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
                "ell_rmatvec": 2, "ell_matvec": 0, "flash_attention": 0, "flash_attention_bwd": 0,
                "two_level_draw_lanes": 0, "coord_update_lanes": 0, "scatter_add_ordered": 0}
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
    reset_launch_counts()
    prof = profile_steps("private", 100, lambda: fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0,
                                                                WARMUP, None, steps=100, **kw))
    return per_step, private_window(prof, 100, launch_counts())


# the kernels of a private step: coord_update's two and the rebuilding draw
PRIVATE_STEP_KERNELS = ("rows_kernel", "owners_kernel", "two_level_draw_kernel<true>")


def _device_ms_of(prof: dict, name: str) -> tuple:
    """(device ms, calls) of the profiled kernels whose name holds ``name``."""
    return (sum(ms for k, ms in prof["by_kernel"].items() if name in k),
            sum(c for k, c in prof["calls"].items() if name in k))


def profile_replay(run: str, steps: int, window, kernel: str) -> tuple:
    """(device ms, profiled launches, retakes) of ``kernel`` over ``window()``,
    which launches it ``steps`` times.  The profile must hold at least 99% of
    the launches.  The profiler now and then drops more records of a window
    (seen: 194 of 200 lane draws, in one run of several), so a profile that
    holds fewer is taken again, at most twice; the bound holds on the one
    kept, and the retakes are reported."""
    for retakes in range(3):
        ms, calls = _device_ms_of(profile_steps(run, steps, window, quiet=True), kernel)
        if 0.99 * steps <= calls <= steps:
            return ms, calls, retakes
        emit("profile_retake", run=run, profiled_launches=calls, launches=steps)
    raise RuntimeError(f"chip_smoke: {run}: {calls} profiled launches of {steps}, three times")


def window_calls(prof: dict, steps: int, counts: dict, wrappers: tuple, run: str) -> dict:
    """Profiled launches of each of ``PRIVATE_STEP_KERNELS`` in a window of
    ``steps`` steps. The wrappers' counters over the same window (``counts``)
    must show each of ``wrappers`` launched once a step, exactly. The
    profiler may drop a record of a window (seen as 99 of 100 draw launches
    in a window whose wrappers launch one a step), so it must hold each
    kernel's launches but at most one."""
    want = {name: steps for name in wrappers}
    got = {name: counts[name] for name in wrappers}
    require(got == want, f"{run}: wrapper launches {got}, expected {want}")
    calls = {name: _device_ms_of(prof, name)[1] for name in PRIVATE_STEP_KERNELS}
    require(all(steps - 1 <= c <= steps for c in calls.values()),
            f"{run}: profiled {calls}, expected {steps} calls of each (one may be dropped)")
    return calls


def private_window(prof: dict, steps: int, counts: dict) -> dict:
    """The private step runs the rows, owners and draw kernels once each and
    no other device kernel once a step or more (the rebuild's torch ops are
    gone: the draw launch rebuilds)."""
    calls = window_calls(prof, steps, counts, ("coord_update", "two_level_draw"),
                         "private window")
    others = {k[:80]: c for k, c in prof["calls"].items()
              if c >= steps and not any(name in k for name in PRIVATE_STEP_KERNELS)}
    require(not others, f"private window: other kernels launched every step: {others}")
    fields = dict(steps=steps, calls=calls, kernels_per_step=sum(prof["calls"].values()) / steps,
                  device_ms_per_step={name: _device_ms_of(prof, name)[0] / calls[name]
                                      for name in PRIVATE_STEP_KERNELS},
                  other_kernels={k[:80]: c for k, c in prof["calls"].items()
                                 if not any(name in k for name in PRIVATE_STEP_KERNELS)})
    emit("private_window", **fields)
    return fields


# the throwaway kernel a profiler session starts on (torch.cuda._sleep's)
WARMUP_KERNEL = "spin_kernel"


def _profiler_warmup() -> None:
    """Run a few throwaway kernels at the start of a profiler session and
    wait for them: a session can miss the first kernels after it starts
    (seen as 99 of 100 launches of a window's first kernels)."""
    for _ in range(3):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profile_steps(run: str, steps: int, window, quiet: bool = False,
                  device_only: bool = False) -> dict:
    """Device time by kernel over ``window()``, a run of ``steps`` steps
    (torch.profiler); returns the device ms by kernel name (``quiet``: no
    phase line; ``device_only``: no CPU ops recorded, so no ``by_op``, and
    about a quarter of the events to parse)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if not device_only:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _profiler_warmup()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _profiler_warmup()     # the window's last kernels are not the session's
    events = prof.key_averages()
    # device-side events only: CPU ops also carry the device time of their kernels
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0 and WARMUP_KERNEL not in e.key),
                       key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    # the device ms of the kernels each host-side op launched itself (aten::bmm: the
    # expert products)
    by_op = {e.key: e.self_device_time_total / 1e3 for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.self_device_time_total > 0}
    out = {"wall_ms": wall_ms, "by_kernel": {k: ms for k, ms, _ in by_kernel},
           "calls": {k: c for k, _, c in by_kernel}, "by_op": by_op}
    if quiet:
        return out
    emit("profile", run=run, steps=steps, wall_ms_profiled=wall_ms,
         device_busy_ms=busy_ms if by_kernel else None,
         device_idle_share=(1.0 - busy_ms / wall_ms) if by_kernel else None,
         top_device=[{"name": k[:80], "ms": ms, "calls": c} for k, ms, c in by_kernel[:8]],
         note=None if by_kernel else "the profiler recorded no device time")
    return out


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
                "two_level_draw": 0, "flash_attention": 0, "flash_attention_bwd": 0,
                "two_level_draw_lanes": 0,
                "coord_update_lanes": 0, "scatter_add_ordered": 0}
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


def phase_parity(X, y, pcsr, pcsc, col_nnz):
    """Card against CPU (plain versions) at full width, T = 200; returns the
    dense-matrix Alg 1 run (``phase_alg1_parity``) and the CPU's padded pair."""
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
    return phase_alg1_parity(X, y, pcsr, pcsc, cpu_pair), cpu_pair


def phase_alg1_parity(X, y, pcsr, pcsc, cpu_pair):
    """Alg 1 card against CPU at T = 200: argmax must take the CPU's
    coordinates; for the private rules, whose noise goes through torch's
    log/log1p (an ulp from the CPU's), a differing step is reported.  Then
    the dense (N, D) form on the card must take the padded form's argmax
    coordinates; that run is returned."""
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
    return dense


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


def phase_duplicates(X, csc, y, y_t, buckets) -> tuple:
    """Repeated entries (a row that lists a column twice), at the rcv1.binary
    shape: the head, p99 and light columns each get repeated entries (3, 3
    and 1 of their rows' entries listed again in the HostCSR, not summed),
    and 5,000 entries anywhere (so the private runs draw such columns too).  The card must meet the kernel's bitwise rule
    against the CPU on those columns (every loss, both queues, both routes
    and a rerun the same bits), and T_DUP-step runs with each route forced
    must take the CPU's coordinates and w bit for bit, the gaps within 1e-4
    (g̃'s sum is held allclose by the rule).  Returns the copy and the CPU
    runs, {private: (w, coords)}."""
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
    runs, cpu_runs = {}, {}
    for private in (True, False):
        w_cpu, gaps_cpu, coords_cpu = _alg2_scan(cpu_pair, y, private, "auto")
        cpu_runs[private] = (w_cpu, coords_cpu)
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
    return Xd, cpu_runs


def _stopped_prefix(res, full, tol: float, name: str) -> dict:
    """``res`` (run with ``gap_tol=tol``) stops at ``full``'s first gap <= tol
    and is a bitwise prefix of it, with sentinels after the stop."""
    gaps = full.gaps.cpu().numpy()
    k = int(np.argmax(gaps <= np.float32(tol)))
    stop = res.stop_step_or()
    require(res.stop_reason == "gap_tol" and stop == k + 1 < T_MAIN,
            f"{name}: stopped at {stop} ({res.stop_reason}), expected {k + 1}")
    require(torch.equal(res.coords[:stop], full.coords[:stop])
            and torch.equal(res.gaps[:stop], full.gaps[:stop]),
            f"{name}: the stopped run is not a prefix of the fixed-T run")
    require(bool((res.coords[stop:] == -1).all() and (res.gaps[stop:] == 0).all()),
            f"{name}: no sentinels after the stop")
    return dict(gap_tol=tol, expected_stop_step=k + 1, stop_step=stop, prefix_bitwise_equal=True)


def _least_positive_half(res) -> float:
    """The least positive gap of the first T/2 steps of ``res``, so the stop
    lands in the first half even on a private trace, which is read at
    DP-drawn coordinates, need not fall and may dip below zero (the gap at
    step T/2 itself can lie above the first step's); the expected stop is
    the fixed run's first step at or below it."""
    half = res.gaps.cpu().numpy()[: T_MAIN // 2]
    return float(half[half > 0].min())


def phase_gap_tol(pcsr, pcsc, y, runs, alg1) -> None:
    """gap_tol runs through the chunk loop: each stops before T and is a
    bitwise prefix of its fixed-T run, with sentinels after the stop."""
    fixed = {"dense_argmax": (alg1["argmax"]["res"], _alg1_config("argmax", T_MAIN))}
    for name in ("private", "non_private"):
        fixed[f"torch_sparse_{name}"] = (runs[name]["res"], FWConfig(
            backend="torch_sparse", lam=LAM, steps=T_MAIN, epsilon=1.0, delta=1e-6,
            queue="two_level" if name == "private" else "group_argmax", device=DEVICE))
    for name, (full, cfg) in fixed.items():
        tol = _least_positive_half(full)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve((pcsr, pcsc), y, dataclasses.replace(cfg, gap_tol=tol))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        emit("gap_tol", run=name, stop_reason=res.stop_reason, solve_s=wall,
             launches=launch_counts(), **_stopped_prefix(res, full, tol, name))


def _store_disk_need(X, pcsr, pcsc) -> int:
    """Bytes the store phase writes at most at once: the LIBSVM text (at most
    40 B an entry), the store's shards twice (two shard sizes) and the padded
    cache, both layouts."""
    shards = 16 * X.nnz + 24 * N + 8
    padded = 8 * (pcsc.indices.numel() + pcsr.indices.numel()) + 4 * (N + D)
    return 40 * X.nnz + 2 * shards + padded


def _store_solve(store, cfg, want: dict) -> dict:
    """One ``solve(store)`` on the card with the launch counts reset just
    before; its span times (``repro_torch.obs``) and launches."""
    reset_launch_counts()
    with obs.session() as tel:
        t0 = time.perf_counter()
        res = solve(store, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    require(counts == want, f"store solve {cfg.backend} {cfg.queue}: launches {counts}, "
            f"expected {want}")
    spans = {e["name"]: e["dur_s"] for e in tel.events if e["ev"] == "span"}
    return dict(res=res, wall=wall, counts=counts, run_s=spans["solve.run"],
                coerce_s=spans["solve.coerce"], per_step_ms=spans["solve.run"] * 1e3 / cfg.steps,
                cache={f"{m['labels']['cache']}_{m['labels']['outcome']}": m["value"]
                       for m in tel.metrics.snapshot() if m["name"] == "store.cache"})


def _same_run(got, ref, name: str) -> None:
    for k in ("coords", "w", "gaps", "losses"):
        a, b = getattr(got, k), getattr(ref, k)
        require(torch.equal(a.cpu(), b.cpu()), f"store {name}: {k} differs from the in-memory run")


def phase_store(X, y, y_t, pcsr, pcsc, runs, dense, pad_s, dup) -> None:
    """The dataset store at the rcv1.binary shape: the matrix as LIBSVM text,
    ingested at two shard sizes (the same content hash), opened cold
    (padded and setup caches written) and warm (both replayed), and solved
    from the store on the card: Alg 2 private and non-private at T = 500
    and Alg 1 ``argmax`` on the dense form at T = 200, each equal to the
    in-memory run bit for bit.  ``setup_streamed`` is held to the JAX
    package's tolerances (α₀ 1e-5, q̄₀ 1e-6) of the kernel setup.  Then the
    repeated-entries copy goes through text and a store, T = 50 a queue."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        free = shutil.disk_usage(tmp).free
        need = _store_disk_need(X, pcsr, pcsc)
        require(free >= need, f"store phase: {free} bytes free under {tmp}, needs {need}")
        text = os.path.join(tmp, "rcv1_shape.libsvm")
        t0 = time.perf_counter()
        write_libsvm(text, X, y)
        write_s = time.perf_counter() - t0
        root = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        store = DatasetStore.write(root, iter_libsvm(text, chunk_rows=8192), n_cols=D,
                                   rows_per_shard=STORE_ROWS_PER_SHARD[0])
        ingest_s = time.perf_counter() - t0
        other = DatasetStore.write(os.path.join(tmp, "store_b"),
                                   iter_libsvm(text, chunk_rows=5000), n_cols=D,
                                   rows_per_shard=STORE_ROWS_PER_SHARD[1])
        require(other.content_hash == store.content_hash and other.n_shards != store.n_shards,
                "store: the content hash depends on the shard size")
        shutil.rmtree(other.root)
        host = store.to_host_csr()
        for k in ("indptr", "indices", "data"):
            require(np.array_equal(getattr(host, k), getattr(X, k)),
                    f"store: HostCSR {k} differs from the generated matrix")
        require(np.array_equal(store.labels(), y), "store: labels differ")
        text_bytes = os.path.getsize(text)
        os.remove(text)

        alg2 = {name: FWConfig(backend="torch_sparse", lam=LAM, steps=T_MAIN, loss="logistic",
                               epsilon=1.0, delta=1e-6, device=DEVICE,
                               queue="two_level" if name == "private" else "group_argmax")
                for name in ("private", "non_private")}
        refs = {"private": runs["private"]["res"], "non_private": runs["non_private"]["res"],
                "alg1_dense_argmax": dense}
        cfgs = {**alg2, "alg1_dense_argmax": _alg1_config("argmax", T_PARITY)}
        none = dict.fromkeys(launch_counts(), 0)
        solves, opened, prep_s, peak = {}, {}, {}, {}
        for phase in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            opened[phase] = DatasetStore.open(root)
            with obs.session() as tel:
                t0 = time.perf_counter()
                opened[phase].prepared(DEVICE)
                torch.cuda.synchronize()
                prep_s[phase] = time.perf_counter() - t0
            prep_s[phase + "_spans"] = {e["name"]: e["dur_s"] for e in tel.events
                                        if e["ev"] == "span"}
            cache = {f"{m['labels']['cache']}_{m['labels']['outcome']}": m["value"]
                     for m in tel.metrics.snapshot() if m["name"] == "store.cache"}
            want = {"padded_miss": 1} if phase == "cold" else {"padded_hit": 1}
            require(cache == want, f"store {phase} prepared(): cache {cache}, expected {want}")
            setup_launches = 2 if phase == "cold" else 0     # ȳ and α₀; replayed when warm
            for name, cfg in cfgs.items():
                want = dict(none)
                if name != "alg1_dense_argmax":
                    want.update(coord_update=T_MAIN, ell_rmatvec=setup_launches,
                                two_level_draw=T_MAIN if name == "private" else 0)
                    setup_launches = 0     # the setup is memoized on the open store
                got = _store_solve(opened[phase], cfg, want)
                _same_run(got["res"], refs[name], f"{phase} {name}")
                solves.setdefault(name, {})[phase] = {k: v for k, v in got.items() if k != "res"}
            cache = solves["private"][phase]["cache"]
            want = ({"setup_miss": 1, "autotune_miss": 1} if phase == "cold"
                    else {"setup_hit": 1, "autotune_miss": 1})
            require(cache == want, f"store {phase} private solve: cache {cache}, expected {want}")
            peak[phase] = torch.cuda.max_memory_allocated()
            if phase == "cold":
                del opened["cold"]      # its hooks refer back to it: a cycle
                gc.collect()
                torch.cuda.empty_cache()
        # the same solves in memory, timed the same way (their span times)
        for name, cfg in alg2.items():
            with obs.session() as tel:
                solve((pcsr, pcsc), y, cfg)
            run_s = next(e["dur_s"] for e in tel.events if e["name"] == "solve.run")
            solves[name]["memory"] = dict(run_s=run_s, per_step_ms=run_s * 1e3 / T_MAIN)

        warm = opened["warm"]
        prep = warm.prepared(DEVICE)
        streamed = {}
        for loss in ("logistic", "huber"):
            v0, q0, a0 = warm.setup_streamed(loss, device=DEVICE)
            kv, kq, ka = prep.setup_for(y_t, loss)
            da, dq = float((a0 - ka).abs().max()), float((q0 - kq).abs().max())
            require(da <= 1e-5 and dq <= 1e-6 and not bool(v0.any()),
                    f"setup_streamed {loss}: alpha0 {da} (1e-5), qbar0 {dq} (1e-6)")
            streamed[loss] = dict(max_abs_alpha0=da, max_abs_qbar0=dq)
        tuned = _store_autotune(warm, root, prep, y, refs)
        cache_dir = os.path.join(root, "cache")
        cache_bytes = {f: os.path.getsize(os.path.join(cache_dir, f))
                       for f in sorted(os.listdir(cache_dir))}
        del prep, warm, opened
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root)
        dups = _store_duplicates(tmp, *dup, y)
        emit("store", n=N, d=D, nnz=X.nnz, shards=store.n_shards,
             rows_per_shard=list(STORE_ROWS_PER_SHARD), content_hash=store.content_hash,
             hash_equal_across_shard_sizes=True, host_csr_bitwise_equal=True,
             free_disk_bytes=free, disk_needed_bytes=need, libsvm_bytes=text_bytes,
             write_libsvm_s=write_s, ingest_s=ingest_s, pad_on_card_s=pad_s,
             cold_prepared_s=prep_s["cold"], warm_prepared_s=prep_s["warm"],
             cold_prepared_spans_s=prep_s["cold_spans"],
             warm_prepared_spans_s=prep_s["warm_spans"],
             cache_bytes=cache_bytes, max_memory_allocated=peak, solves=solves, bitwise_equal_in_memory=True,
             setup_streamed=streamed, duplicates=dups, autotune=tuned)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _store_duplicates(tmp, Xd, cpu_runs, y) -> dict:
    """The repeated-entries copy through LIBSVM text (a line lists a column
    twice) and a store, T_DUP steps a queue on the card: the coordinates and
    w of the CPU runs of ``phase_duplicates``."""
    text = os.path.join(tmp, "duplicates.libsvm")
    write_libsvm(text, Xd, y)
    store = DatasetStore.write(os.path.join(tmp, "duplicates"), iter_libsvm(text), n_cols=D,
                               rows_per_shard=STORE_ROWS_PER_SHARD[0])
    require(np.array_equal(store.to_host_csr().indices, Xd.indices),
            "duplicates store: the repeated entries did not survive the text")
    out = {}
    for private, (w_cpu, coords_cpu) in cpu_runs.items():
        cfg = FWConfig(backend="torch_sparse", lam=LAM, steps=T_DUP, epsilon=1.0, delta=1e-6,
                       device=DEVICE, queue="two_level" if private else "group_argmax")
        res = solve(store, config=cfg)
        name = "private" if private else "non_private"
        require(torch.equal(res.coords.cpu(), coords_cpu) and torch.equal(res.w.cpu(), w_cpu),
                f"duplicates store {name}: coords or w differ from the CPU run")
        out[name] = dict(steps=T_DUP, coords_equal=True, w_bitwise_equal=True)
    shutil.rmtree(store.root)
    os.remove(text)
    return out


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
    # the profiler may drop an event of a window: ms per recorded launch
    ms, calls, _ = profile_replay("rebuilding draw replay", DRAW_STEPS, lambda: replay(
        lambda k: two_level_draw(state.c, state.v, k, touched=state.touched)),
        "two_level_draw_kernel<true>")
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
# the sweep (solve_many), its lane kernels, the autotuner, backend="auto"
# ---------------------------------------------------------------------------


def _sweep_configs(private: bool):
    """The private grid λ × ε (B = 8, ``two_level``) or the non-private grid
    of λ (B = 4), logistic, T = 500."""
    base = FWConfig(backend="torch_sparse", steps=T_MAIN, loss="logistic", delta=1e-6,
                    device=DEVICE, queue="two_level" if private else "group_argmax")
    return grid(base, lam=SWEEP_LAMS, epsilon=SWEEP_EPS if private else 1.0)


def _same_as_solve(got, ref, name: str) -> None:
    for k in ("coords", "w", "gaps"):
        require(torch.equal(getattr(got, k), getattr(ref, k)),
                f"{name}: {k} differs from the config's own solve")
    require((got.stop_step_or(), got.stop_reason) == (ref.stop_step_or(), ref.stop_reason),
            f"{name}: stop step or reason differs from the config's own solve")


def phase_sweep(pcsr, pcsc, y) -> dict:
    """``solve_many`` over the private grid (B = 8) and the non-private grid
    (B = 4), each ``plan="vmap"`` (lanes) and ``plan="sequential"``, twice
    (the cost book drops a key's first reading): every config equals its own
    ``solve`` bit for bit; the lanes launch each kernel once a step for the
    whole group and ``ell_rmatvec`` twice a group.  Per-config wall, steps/s
    over the lanes, the lane cost ratio (vmap wall over sequential wall: a
    lane's step in sequential steps) and ``plan_for`` before and after the
    cost book has readings.  Then the idle share of 100 private lane steps
    and a ``gap_tol`` cohort."""
    pair = (pcsr, pcsc)
    planner.clear_costbook()
    out = {}
    for private in (True, False):
        name = "private" if private else "non_private"
        cfgs = _sweep_configs(private)
        lanes = len(cfgs)
        before = plan_for(pair, cfgs)
        t0 = time.perf_counter()
        refs = [solve(pair, y, c) for c in cfgs]
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        runs = {}
        for mode in ("vmap", "sequential") * 2:
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = solve_many(pair, y, cfgs, plan=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            rebuilds = two_level_draw_lanes.rebuilds + two_level_draw.rebuilds
            per, sfx = (lanes, "") if mode == "sequential" else (1, "_lanes")
            want = dict.fromkeys(counts, 0)
            want.update({"coord_update" + sfx: per * T_MAIN, "ell_rmatvec": 2})
            if private:
                want["two_level_draw" + sfx] = per * T_MAIN
            require(counts == want, f"sweep {name} {mode}: launches {counts}, expected {want}")
            require(rebuilds == (per if private else 0),
                    f"sweep {name} {mode}: {rebuilds} rebuild-only launches")
            for i, (got, ref) in enumerate(zip(res, refs)):
                _same_as_solve(got, ref, f"sweep {name} {mode} config {i}")
            runs.setdefault(mode, []).append(dict(
                wall_s=wall, per_config_s=wall / lanes, lane_steps_per_s=lanes * T_MAIN / wall,
                launches=counts,
                launches_per_step={k: v / T_MAIN for k, v in counts.items()
                                   if v and k != "ell_rmatvec"},
                ell_rmatvec_per_group=counts["ell_rmatvec"], rebuild_only_launches=rebuilds,
                max_memory_allocated=torch.cuda.max_memory_allocated()))
        lane_cost = runs["vmap"][-1]["wall_s"] / runs["sequential"][-1]["wall_s"]
        stats = planner.data_stats(pair)
        book = {m: planner.measured_cost("torch_sparse", m, "torch-cuda", stats)
                for m in ("vmap", "sequential")}
        emit("sweep", run=name, lanes=lanes, steps=T_MAIN, lams=list(SWEEP_LAMS),
             epsilons=sorted({c.epsilon for c in cfgs}), per_config_solve_s=solve_s / lanes,
             vmap=runs["vmap"], sequential=runs["sequential"], lane_cost_ratio=lane_cost,
             accel_vmap_lane_overhead=planner.ACCEL_VMAP_LANE_OVERHEAD,
             plan_for_before=before.mode, plan_for_after=plan_for(pair, cfgs).mode,
             costbook_s_per_step_lane=book, bitwise_equal_own_solve=True)
        out[name] = dict(cfgs=cfgs, refs=refs, runs=runs, lane_cost=lane_cost)
    out["window"] = _lane_window(pcsr, pcsc, y, out["private"]["cfgs"])
    out["cohort"] = _sweep_cohort(pair, y, out["private"])
    return out


def _lanes_of(setup, cfgs, private: bool = True):
    """Stacked carries and scalars of ``cfgs`` over one setup."""
    em = [em_scale_for(c, N) for c in cfgs]
    carry = fw_carry_init_lanes(D, torch.float32, *setup, em,
                                [prng.PRNGKey(c.seed) for c in cfgs], private=private)
    return carry, lane_scalars([c.lam for c in cfgs], em, [c.gap_tol for c in cfgs], DEVICE)


def _lane_window(pcsr, pcsc, y, cfgs) -> dict:
    """100 private lane steps at B = 8 under the profiler: device busy ms and
    idle share, and the kernels a step (the rows, owners and draw kernels
    once each, whatever B)."""
    setup = fw_setup(pcsr, torch.from_numpy(y.astype(np.float32)).to(DEVICE), loss="logistic",
                     pcsc=pcsc)
    carry, sc = _lanes_of(setup, cfgs)
    kw = dict(loss="logistic", private=True,
              scratch=coord_update_scratch(N, D, DEVICE, lanes=len(cfgs)))
    fw_scan_chunk_lanes(pcsr, pcsc, carry, sc, 0, None, steps=WARMUP, **kw)
    reset_launch_counts()
    prof = profile_steps("sweep_private_lanes", 100, lambda: fw_scan_chunk_lanes(
        pcsr, pcsc, carry, sc, WARMUP, None, steps=100, **kw))
    calls = window_calls(prof, 100, launch_counts(),
                         ("coord_update_lanes", "two_level_draw_lanes"), "sweep window")
    busy = sum(prof["by_kernel"].values())
    fields = dict(lanes=len(cfgs), steps=100, calls=calls,
                  kernels_per_step=sum(prof["calls"].values()) / 100,
                  wall_ms_per_step=prof["wall_ms"] / 100, device_busy_ms_per_step=busy / 100,
                  device_idle_share=1.0 - busy / prof["wall_ms"],
                  device_ms_per_step={n: _device_ms_of(prof, n)[0] / calls[n]
                                      for n in PRIVATE_STEP_KERNELS})
    emit("sweep_window", **fields)
    return fields


def _tol_near(gaps: np.ndarray, k: int) -> float:
    """A tolerance > 0 midway between two distinct positive gap values of a
    fixed-T trace (or below the least one), whose first crossing lies
    nearest step k (a private trace is read at DP-drawn coordinates and
    crosses where it may)."""
    pos = np.unique(gaps[gaps > 0]).astype(np.float64)
    cands = [0.5 * pos[0]] + [0.5 * (a + b) for a, b in zip(pos[:-1], pos[1:])]
    first = lambda tol: int(np.argmax(gaps <= np.float32(tol)))
    return min(cands, key=lambda tol: abs(first(tol) - k))


def _sweep_cohort(pair, y, private: dict) -> dict:
    """A ``gap_tol`` cohort of the private grid's four ε = 1 configs, each
    tolerance chosen on its own fixed-T trace to cross first near step 100,
    200, 300 or 400: each config equals its own ``solve`` and retires at its
    own step, between chunks."""
    picks = [i for i, c in enumerate(private["cfgs"]) if c.epsilon == 1.0]
    cfgs = [dataclasses.replace(private["cfgs"][i],
                                gap_tol=_tol_near(private["refs"][i].gaps.cpu().numpy(), k))
            for k, i in zip((T_MAIN // 5, 2 * T_MAIN // 5, 3 * T_MAIN // 5, 4 * T_MAIN // 5),
                            picks)]
    refs = [solve(pair, y, c) for c in cfgs]
    reset_launch_counts()
    with obs.session() as tel:
        t0 = time.perf_counter()
        got = solve_many(pair, y, cfgs, plan="vmap")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    for i, (g, ref) in enumerate(zip(got, refs)):
        _same_as_solve(g, ref, f"sweep cohort config {i}")
    start = next(e["ts"] for e in tel.events if e["ev"] == "span" and e["name"] == "group.cohort")
    retired = {e["attrs"]["config"]: e for e in tel.events
               if e["ev"] == "event" and e["name"] == "cohort.retire"}
    require(sorted(retired) == list(range(len(cfgs))), "sweep cohort: not every config retired")
    rows = [dict(lam=c.lam, epsilon=c.epsilon, gap_tol=c.gap_tol, stop_step=g.stop_step_or(),
                 stop_reason=g.stop_reason, own_solve_stop_step=ref.stop_step_or(),
                 retired_after_s=retired[i]["ts"] - start)
            for i, (c, g, ref) in enumerate(zip(cfgs, got, refs))]
    chunks = [m for m in tel.metrics.snapshot() if m["name"] == "cohort.chunk.seconds"]
    emit("sweep_cohort", configs=rows, chunk_steps=planner.default_chunk(T_MAIN),
         chunks=chunks[0]["count"] if chunks else 0, wall_s=wall, launches=counts,
         bitwise_equal_own_solve=True)
    return dict(rows=rows, wall=wall)


def lane_kernel_times(X, csc, y_t, pcsr, pcsc, runs, sweep, buckets) -> list:
    """The lane forms of ``coord_update`` and ``two_level_draw`` at the rcv1.binary
    shape: held against the single-config kernel on each lane (bit for bit)
    and against their plain versions (the update by its bitwise rule per
    lane on the CPU, one lane done; the draw over LANE_STEPS steps of real
    touched sets: c within rtol/atol 1e-6 of the plain rebuild, each draw the
    plain draw on the kernel's c, every arrival counter 0 after each launch);
    then the device ms per launch at B = 1, 4, 8 (the private run's columns,
    lane b shifted by 61 steps) against B times the single-lane bound.  The
    two ``kernels`` entries report B = 8."""
    setup = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    cfgs = sweep["private"]["cfgs"]
    vmap_counts = sweep["private"]["runs"]["vmap"][-1]["launches"]
    coords = runs["private"]["res"].coords.cpu().numpy()
    lanes_max = max(LANE_WIDTHS)
    group_size = _lanes_of(setup, cfgs[:1])[0].sampler.group_size
    one_bytes, one_ops = _coord_update_bytes(X, csc, coords, group_size)
    # ---- coord_update_lanes against the single kernel and the plain version ----
    cols = [buckets["light"], buckets["p99"], buckets["head"]] + \
        [int(c) for c in coords[:lanes_max]]
    carry, sc = _lanes_of(setup, cfgs)
    fw_scan_chunk_lanes(pcsr, pcsc, carry, sc, 0, None, steps=20, loss="logistic", private=True)
    done = torch.zeros(lanes_max, dtype=torch.bool, device=DEVICE)
    done[-1] = True
    stop_at = torch.zeros(lanes_max, dtype=torch.int32, device=DEVICE)
    js = torch.tensor(cols[:lanes_max], dtype=torch.int32, device=DEVICE)
    state = lambda c: dict(w=c.w, w_m=c.w_m, g_tilde=c.g_tilde, vbar=c.vbar, qbar=c.qbar,
                           alpha=c.alpha, queue=c.sampler)
    before = {k: (v.to("cpu") if k == "queue" else v.cpu().clone())
              for k, v in state(carry).items()}
    singles = [{k: (v.lane(b).clone() if k == "queue" else v[b].clone())
                for k, v in state(carry).items()} for b in range(lanes_max)]
    gaps = torch.zeros((lanes_max, 1), device=DEVICE)
    cds = torch.zeros((lanes_max, 1), dtype=torch.int32, device=DEVICE)
    scratch = coord_update_scratch(N, D, DEVICE, lanes=lanes_max)
    step = dict(t=21.0, inv_n=1.0 / N, loss="logistic", gaps=gaps, coords=cds, slot=0)
    coord_update_lanes(js, pcsr, pcsc, None, *state(carry).values(), scalars=sc,
                       scratch=scratch, done=done, stop_at=stop_at, **step)
    one = coord_update_scratch(N, D, DEVICE)
    for b in range(lanes_max):
        g1, c1 = torch.zeros(1, device=DEVICE), torch.zeros(1, dtype=torch.int32, device=DEVICE)
        sb = singles[b]
        coord_update(js[b:b + 1], pcsr, pcsc, None, *sb.values(), t=21.0, lam=sc.lam[b],
                     inv_n=1.0 / N, em_scale=sc.em_scale[b], loss="logistic", gaps=g1,
                     coords=c1, slot=0, scratch=one, done=done[b:b + 1].clone(),
                     stop_at=stop_at[b:b + 1].clone())
        lane = {k: (v.lane(b) if k == "queue" else v[b]) for k, v in state(carry).items()}
        require(all(same_bits(a, c) for a, c in zip(
            [lane[k] for k in ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha")]
            + [lane["queue"].v, lane["queue"].c, lane["queue"].touched, gaps[b], cds[b]],
            [sb[k] for k in ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha")]
            + [sb["queue"].v, sb["queue"].c, sb["queue"].touched, g1, c1])),
            f"coord_update_lanes: lane {b} (column {cols[b]}) differs from the single kernel")
    cpu_csr, cpu_csc = pcsr.to("cpu"), pcsc.to("cpu")
    plain = {k: v.clone() for k, v in before.items()}
    sc_cpu = lane_scalars(sc.lam, sc.em_scale, sc.gap_tol)
    pg, pc = torch.zeros((lanes_max, 1)), torch.zeros((lanes_max, 1), dtype=torch.int32)
    coord_update_lanes(js.cpu(), cpu_csr, cpu_csc, None, *plain.values(), scalars=sc_cpu,
                       t=21.0, inv_n=1.0 / N, loss="logistic", gaps=pg, coords=pc, slot=0,
                       done=done.cpu(), stop_at=stop_at.cpu())
    after = {k: (v.to("cpu") if k == "queue" else v.cpu()) for k, v in state(carry).items()}
    err = max(float((after[k] - plain[k]).abs().max()) for k in
              ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha"))
    err = max(err, float((after["queue"].v - plain["queue"].v).abs().max()))
    routes = scratch.routes[:lanes_max - 1].sum(0).tolist()
    for b in range(lanes_max - 1):      # the last lane is done: sentinels only
        k = int(pcsc.nnz[cols[b]])
        lane_after = {key: (v.lane(b) if key == "queue" else v[b]) for key, v in after.items()}
        lane_after.update(gaps=gaps[b].cpu(), coords=cds[b].cpu())
        lane_before = {key: (v.lane(b) if key == "queue" else v[b]) for key, v in before.items()}
        bad = bitwise_rule_mismatches(cols[b], cpu_csr, cpu_csc, None, lane_before, lane_after,
                                      scratch.gs[b, :k].cpu(), t=21.0, lam=sc.lam[b],
                                      inv_n=1.0 / N, em_scale=sc.em_scale[b], loss="logistic")
        require(bad == [], f"coord_update_lanes: lane {b} (column {cols[b]}) breaks the "
                           f"bitwise rule: {bad}")
    require(int(cds[-1, 0]) == -1 and float(gaps[-1, 0]) == 0.0,
            "coord_update_lanes: the done lane wrote no sentinel")
    require(routes[0] > 0 and routes[1] > 0, f"coord_update_lanes: routes {routes}")
    del singles, before, after, plain
    # ---- timing: the private run's columns, each lane shifted -----------------------
    cu = {}
    for lanes in LANE_WIDTHS:
        carry, sc = _lanes_of(setup, cfgs[:lanes])
        scratch = coord_update_scratch(N, D, DEVICE, lanes=lanes)
        g, c = (torch.zeros((lanes, T_MAIN), device=DEVICE),
                torch.zeros((lanes, T_MAIN), dtype=torch.int32, device=DEVICE))
        jl = [torch.tensor([int(coords[(i + 61 * b) % len(coords)]) for b in range(lanes)],
                           dtype=torch.int32, device=DEVICE) for i in range(T_MAIN)]
        launches = [lambda i=i: coord_update_lanes(
            jl[i], pcsr, pcsc, None, carry.w, carry.w_m, carry.g_tilde, carry.vbar, carry.qbar,
            carry.alpha, carry.sampler, t=float(i + 1), scalars=sc, inv_n=1.0 / N,
            loss="logistic", gaps=g, coords=c, slot=i, scratch=scratch)
            for i in range(T_MAIN)]
        ms = device_ms(launches)
        bd, by = bound(lanes * one_bytes, lanes * one_ops)
        row = dict(ms=ms, bound_ms=bd, bound_by=by, ms_per_lane=ms / lanes)
        if lanes == lanes_max:
            plain_carry = dataclasses.replace(carry)
            row["plain_ms"] = sync_ms(lambda: [coord_update_lanes_ref(
                jl[i], pcsr, pcsc, None, plain_carry.w, plain_carry.w_m, plain_carry.g_tilde,
                plain_carry.vbar, plain_carry.qbar, plain_carry.alpha, plain_carry.sampler,
                t=float(i + 1), scalars=sc, inv_n=1.0 / N, loss="logistic", gaps=g, coords=c,
                slot=i) for i in range(20)]) / 20
            row["scratch_bytes_per_lane"] = scratch_bytes(N, D, owner_table(pcsc))
        cu[lanes] = row
    # ---- two_level_draw_lanes over real touched sets --------------------------------
    dr = {}
    for lanes in LANE_WIDTHS:
        carry, _ = _lanes_of(setup, cfgs[:lanes])
        st = carry.sampler
        chains = [prng.key_chain(prng.PRNGKey(9 + b), LANE_STEPS)[1] for b in range(lanes)]
        table = key_table(chains, DEVICE)
        gen = torch.Generator(DEVICE).manual_seed(4)
        sets, touched_groups = [], 0
        for i in range(LANE_STEPS):
            per = []
            for b in range(lanes):
                rows = pcsc.col_live(int(coords[(i + 61 * b) % len(coords)]))[0].long()
                live = torch.arange(pcsr.indices.shape[1], device=DEVICE)[None, :] < \
                    pcsr.nnz[rows][:, None]
                idx = torch.unique(pcsr.indices[rows][live].long())
                touched_groups += int(torch.unique(idx // st.group_size).numel())
                per.append((idx, st.v[b].view(-1)[idx] * (1.0 + 0.05 * torch.randn(
                    idx.numel(), generator=gen, device=DEVICE))))
            sets.append(per)
        out = torch.empty(lanes, dtype=torch.int32, device=DEVICE)
        done = torch.zeros(lanes, dtype=torch.bool, device=DEVICE)
        worst = 0.0
        if lanes == lanes_max:      # against the plain rebuild and draw, every step
            plain = st.clone()
            for i, per in enumerate(sets):
                for b, (idx, vals) in enumerate(per):
                    tl_scatter_(st.lane(b), idx, vals)
                    tl_scatter_(plain.lane(b), idx, vals)
                two_level_draw_lanes(st.c, st.v, table[i], out, done=done, touched=st.touched)
                for b in range(lanes):
                    rebuild_groups_(plain.c[b], plain.v[b], plain.touched[b])
                require(torch.allclose(st.c, plain.c, rtol=1e-6, atol=1e-6),
                        "two_level_draw_lanes: c differs from the plain rebuild")
                worst = max(worst, float((st.c - plain.c).abs().max()))
                want = torch.cat([two_level_draw_ref(st.c[b], st.v[b], chains[b][i])
                                  for b in range(lanes)])
                require(torch.equal(out, want), "two_level_draw_lanes: a draw differs from "
                                                "the plain draw on its c")
                require(int(st.touched.sum()) == 0 and
                        int(arrival_counter(DEVICE, lanes).abs().sum()) == 0,
                        "two_level_draw_lanes: a group left touched or a counter not at 0")
                plain.c.copy_(st.c)
            t0 = time.perf_counter()
            for i, per in enumerate(sets[:50]):
                for b, (idx, vals) in enumerate(per):
                    tl_scatter_(plain.lane(b), idx, vals)
                two_level_draw_lanes_ref(plain.c, plain.v, table[i], touched=plain.touched)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3 / 50

        def replay():
            for i, per in enumerate(sets):
                for b, (idx, vals) in enumerate(per):
                    tl_scatter_(st.lane(b), idx, vals)
                two_level_draw_lanes(st.c, st.v, table[i], out, done=done, touched=st.touched)
        ms, calls, retakes = profile_replay(f"two_level_draw_lanes replay ({lanes} lanes)",
                                            LANE_STEPS, replay, "two_level_draw_kernel<true>")
        g, m = st.v.shape[1:]
        tg = touched_groups / LANE_STEPS / lanes
        bd, by = bound(lanes * (4.0 * (2 * g + m + 1) + tg * (4.0 * m + 8.0)),
                       lanes * (125.0 * (g + m) + 230.0 + tg * 4.0 * m))
        dr[lanes] = dict(ms=ms / calls, bound_ms=bd, bound_by=by, mean_touched_groups=tg,
                         profiled_launches=calls, profile_retakes=retakes)
        if lanes == lanes_max:
            dr[lanes].update(plain_ms=plain_ms, max_abs_c_err=worst)
    emit("lane_kernels", lanes=list(LANE_WIDTHS), coord_update_lanes=cu,
         two_level_draw_lanes=dr, coord_update_routes=routes, coord_update_max_abs_err=err,
         tolerance="coord_update: bitwise rule per lane (ref.bitwise_rule_mismatches), "
                   "equal to the single kernel bit for bit; draw: c rtol/atol 1e-6, "
                   "draws equal")
    top = lanes_max
    return [dict(name="coord_update_lanes", route="cuda",
                 source="src/repro_torch/kernels/coord_update/csrc/coord_update.cu",
                 replaces="src/repro/kernels/coord_update/kernel.py:156",
                 launches=vmap_counts["coord_update_lanes"], max_abs_err=err,
                 ms=cu[top]["ms"], plain_ms=cu[top]["plain_ms"], bound_ms=cu[top]["bound_ms"],
                 bound_by=cu[top]["bound_by"], library_ms=None, lanes=top,
                 ms_by_lanes={b: r["ms"] for b, r in cu.items()},
                 bound_ms_by_lanes={b: r["bound_ms"] for b, r in cu.items()}),
            dict(name="two_level_draw_lanes", route="cuda",
                 source="src/repro_torch/kernels/bsls_draw/csrc/two_level_draw.cu",
                 replaces="src/repro/kernels/bsls_draw/kernel.py:62",
                 launches=vmap_counts["two_level_draw_lanes"],
                 max_abs_err=dr[top]["max_abs_c_err"], ms=dr[top]["ms"],
                 plain_ms=dr[top]["plain_ms"], bound_ms=dr[top]["bound_ms"],
                 bound_by=dr[top]["bound_by"], library_ms=None, lanes=top,
                 ms_by_lanes={b: r["ms"] for b, r in dr.items()},
                 bound_ms_by_lanes={b: r["bound_ms"] for b, r in dr.items()})]


def _layout_bytes(layout) -> int:
    return sum(t.numel() * t.element_size() for t in vars(layout).values()
               if isinstance(t, torch.Tensor))


def phase_autotune(pcsr, pcsc, y) -> dict:
    """The autotune search on the in-memory pair at the rcv1.binary shape:
    candidate widths, the parity gate, each candidate's per-step ms (the
    worse of a private and a non-private run of 24 steps, best of 3) and
    device bytes, the winner and the chunk."""
    with obs.session() as tel:
        t0 = time.perf_counter()
        rec = autotune((pcsr, pcsc), y, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cands = [e["attrs"] for e in tel.events
             if e["ev"] == "event" and e["name"] == "autotune.candidate"]
    rows = []
    for cand in cands:
        width = None if cand["candidate"] == "flat" else int(cand["candidate"].split("-")[1])
        layout = pcsc if width is None else tiered_from_padded(pcsc, width)
        rows.append(dict(cand, device_bytes=_layout_bytes(layout)))
        del layout
    torch.cuda.empty_cache()
    require(rec.pass_parity and rec.per_iter_tuned_ms <= rec.per_iter_default_ms,
            f"autotune: record {rec}")
    require(all(r["parity"] for r in rows), f"autotune: a tiered candidate failed parity {rows}")
    emit("autotune", source="in_memory", widths=[r["candidate"] for r in rows], candidates=rows,
         winner_ell_width=rec.ell_width, chunk_steps=rec.chunk_steps,
         per_iter_default_ms=rec.per_iter_default_ms, per_iter_tuned_ms=rec.per_iter_tuned_ms,
         search_s=wall, platform=rec.platform)
    return dict(record=rec, rows=rows)


def _store_autotune(store, root: str, prep, y, refs) -> dict:
    """The search on the warm store, its record written; a fresh open
    replays it with no search; the store's private and non-private solves
    on the tuned layout keep their bits."""
    with obs.session():
        t0 = time.perf_counter()
        rec = autotune(store, device=DEVICE)
        search_s = time.perf_counter() - t0
    require(prep.tuning_for("torch_sparse", "logistic") == rec,
            "store autotune: the prepared dataset does not hold the record")
    with obs.session() as tel:
        again = autotune(DatasetStore.open(root), device=DEVICE)
    replayed = [m["value"] for m in tel.metrics.snapshot() if m["name"] == "autotune.replayed"]
    require(again == rec and replayed == [1], "store autotune: the warm open did not replay")
    for name in ("private", "non_private"):
        cfg = FWConfig(backend="torch_sparse", lam=LAM, steps=T_MAIN, loss="logistic",
                       epsilon=1.0, delta=1e-6, device=DEVICE,
                       queue="two_level" if name == "private" else "group_argmax")
        _same_run(solve(store, config=cfg), refs[name], f"tuned {name}")
    fields = dict(record=rec.to_json(), search_s=search_s, replayed_on_warm_open=True,
                  tuned_solves_bitwise_equal=True)
    emit("autotune", source="store", **fields)
    return fields


def phase_auto_backend(pcsr, pcsc, y) -> dict:
    """``backend="auto"`` on the padded pair: the planner's pick, its
    modelled per-step time for each backend (and the cost book's, after the
    autotune fed it) against the measured ``solve.run`` per step; the pick's
    iterates equal the explicit backend's, and the pick is ``torch_sparse``
    unless the book has measured steps of both backends."""
    pair = (pcsr, pcsc)
    cfg = FWConfig(backend="auto", lam=LAM, steps=T_MAIN, loss="logistic", epsilon=1.0,
                   delta=1e-6, device=DEVICE, queue="two_level")
    stats = planner.data_stats(pair)
    with obs.session() as tel:
        res = solve(pair, y, cfg)
    pick = next(e["attrs"]["backend"] for e in tel.events
                if e["ev"] == "span" and e["name"] == "solve")
    run_s = next(e["dur_s"] for e in tel.events if e["ev"] == "span" and e["name"] == "solve.run")
    plan_s = next(e["dur_s"] for e in tel.events if e["ev"] == "span" and e["name"] == "solve.plan")
    _same_run(res, solve(pair, y, dataclasses.replace(cfg, backend=pick)), "auto")
    model = {b: planner.step_time_model(stats, b, "torch-cuda") * 1e3
             for b in ("dense", "torch_sparse")}
    book = {b: planner.measured_cost(b, "sequential", "torch-cuda", stats)
            for b in ("dense", "torch_sparse")}
    require(pick == "torch_sparse" or None not in book.values(),
            f"auto: picked {pick} against a modelled step")
    fields = dict(pick=pick, modelled_step_ms=model,
                  costbook_step_ms={b: None if v is None else v * 1e3 for b, v in book.items()},
                  measured_step_ms=run_s * 1e3 / T_MAIN, plan_s=plan_s,
                  stats=dataclasses.asdict(stats))
    emit("auto_backend", **fields)
    return fields


# ---------------------------------------------------------------------------
# the LM: flash attention, forward, serving, the DP-LASSO probe
# ---------------------------------------------------------------------------


def _qkv(b, s, h, kv, hd, dtype, seed, sk=None):
    """Seeded q (b, s, h, hd) and k, v (b, sk or s, kv, hd)."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    sk = sk or s
    return tuple(torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                 for shape in ((b, s, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))


def plain_block_k(sk: int) -> int:
    """The plain version's k block for S_k keys: its default 1,024, halved
    until it divides S_k (the plain version takes whole blocks)."""
    bk = min(1024, sk)
    while sk % bk:
        bk //= 2
    return bk


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
             ((1, 2048, 10, 1, 256), torch.bfloat16, True, 512),     # recurrentgemma's hd, local
             # recurrentgemma's local attention at full width: its 2,048 window masks
             ((2, 4096, 10, 1, 256), torch.bfloat16, True, 2048),
             # non-causal with q and k of different lengths (seamless' cross-attention)
             ((2, 512, 16, 16, 64, 1536), torch.bfloat16, False, 0),
             ((2, 512, 16, 16, 64, 1536), torch.float32, False, 0)]
    err_lm = {}
    for shape, dtype, causal, window in cases:
        sk = shape[5] if len(shape) > 5 else shape[1]
        q, k, v = _qkv(*shape[:5], dtype, seed=sum(shape), sk=sk)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_k=plain_block_k(sk))
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
        emit("flash_vs_plain", shape=list(shape[:5]), seq_k=sk,
             dtype=str(dtype).replace("torch.", ""),
             causal=causal, window=window, max_abs_err=err, tolerance=tol,
             tolerance_rule="|d| <= tol + tol * |plain|", deterministic=True,
             **({} if ulps is None else dict(
                 max_bf16_ulps_of_scale=ulps, bf16_ulps_bound=FLASH_BF16_ULPS,
                 scaled_rule="|d| <= 4 * 2^-7 * max(|plain|, RMS of the row over hd)")))
    return err_lm


class flash_shapes:
    """Within the block, each flash call of the models is tallied by its shape
    (B, S_q, S_k, causal, window) with the launches its wrapper counted."""

    def __enter__(self):
        self.launches = {}

        def tally(q, k, v, *, causal=True, window=0):
            before = launch_counts()["flash_attention"]
            out = flash_attention(q, k, v, causal=causal, window=window)
            key = (q.shape[0], q.shape[1], k.shape[1], causal, window)
            self.launches[key] = (self.launches.get(key, 0)
                                  + launch_counts()["flash_attention"] - before)
            return out

        model_common.flash_attention = tally
        return self

    def __exit__(self, *exc):
        model_common.flash_attention = flash_attention


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
    reset_launch_counts()
    prof = profile_steps("lm_forward_bf16", 1, fwd)
    require(launch_counts()["flash_attention"] == api.cfg.n_layers,
            f"profiled bf16 forward: {launch_counts()['flash_attention']} flash launches")
    # both routes' kernels are named flash_fwd_*; the bf16 forward runs the mma one
    flash = {k: v for k, v in prof["by_kernel"].items() if "flash_fwd" in k}
    flash_dev = sum(flash.values())
    require(flash_dev > 0 and all("mma" in k for k in flash),
            f"bf16 forward: flash kernels in the profile {list(flash)}")
    flash_calls = sum(c for k, c in prof["calls"].items() if "flash_fwd" in k)
    # the wrappers launched one a layer (above); the profiler may drop a record
    require(api.cfg.n_layers - 1 <= flash_calls <= api.cfg.n_layers,
            f"profiled flash launches {flash_calls}")
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


def _timed_engine(engine) -> dict:
    """Wrap the engine's prefill and decode step to keep each call's host
    seconds (each ends in a host read of the logits)."""
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    engine._prefill_into_slot = timed(engine._prefill_into_slot, "prefill")
    engine._step = timed(engine._step, "decode")
    return times


def phase_lm_serve(api, params, api32, p32) -> None:
    """The serving engine at full width (bf16), and decode == forward (f32)."""
    engine = ServingEngine(api, params, ServeConfig(slots=4, max_len=2048))
    times = _timed_engine(engine)
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
         wall_s=wall, generated_tokens=gen, tokens_per_s=gen / wall,
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


# ---------------------------------------------------------------------------
# DP screening (screen_every) and λ-paths (solve_path)
# ---------------------------------------------------------------------------


def _screen_config(run: str, steps: int, **kw) -> FWConfig:
    """A screened config of ``SCREEN_RUNS[run]``: logistic, λ = 50, ε = 1,
    δ = 1e-6, chunk 62, a round at every boundary."""
    return FWConfig(**{**dict(lam=LAM, steps=steps, loss="logistic", epsilon=1.0, delta=1e-6,
                              chunk_steps=SCREEN_CHUNK, screen_every=1, device=DEVICE),
                       **SCREEN_RUNS[run], **kw})


def _unscreened(cfg: FWConfig) -> FWConfig:
    """The same config without screening, at the ε its selection runs at (a
    private screened run selects at ``solve_epsilon``)."""
    private = cfg.queue == "two_level" or cfg.selection in ("gumbel", "noisy_max")
    return dataclasses.replace(cfg, screen_every=0, epsilon=screening.solve_epsilon(cfg)
                               if private else cfg.epsilon)


class _recorded_rounds:
    """Within the block, each fired round's keep mask (over the columns the
    round saw), survivors (original ids) and the launch counts so far, as
    ``Screener.commit`` folds the round in (the new pair is in place: every
    later launch runs on it until the next fired round)."""

    def __enter__(self):
        self.keeps, self.sels, self.counts = [], [], []
        self._real = real = screening.Screener.commit

        def commit(scr, keep, **kw):
            out = real(scr, keep, **kw)
            self.keeps.append(np.asarray(keep, bool).copy())
            self.sels.append(scr.sel.copy())
            self.counts.append(launch_counts())
            return out

        screening.Screener.commit = commit
        return self

    def __exit__(self, *exc):
        screening.Screener.commit = self._real
        return False


class _keep_all:
    """Within the block every round keeps every coordinate (and still repacks)."""

    def __enter__(self):
        self._real = screening.Screener.screen
        screening.Screener.screen = lambda scr, scores, support: np.ones(scores.shape[0], bool)
        return self

    def __exit__(self, *exc):
        screening.Screener.screen = self._real
        return False


def _host_csr(pcsr) -> HostCSR:
    """The live entries of a padded CSR, as a ``HostCSR``."""
    nnz = pcsr.nnz.cpu().numpy()
    live = np.arange(pcsr.indices.shape[1])[None, :] < nnz[:, None]
    return HostCSR(np.concatenate([[0], np.cumsum(nnz)]), pcsr.indices.cpu().numpy()[live],
                   pcsr.values.cpu().numpy()[live].astype(np.float64), pcsr.shape)


def _alg2_window(pair, y_t, cfg: FWConfig) -> tuple:
    """Per-step ms (host clock, 100 steps after 50) of ``cfg``'s Alg 2 on
    ``pair`` from a fresh carry, and the next 100 steps as a callable (for
    ``_profiled_windows``)."""
    p, q = pair
    em = em_scale_for(cfg, N)
    private = cfg.queue == "two_level"
    setup = fw_setup(p, y_t, loss="logistic", pcsc=q)
    carry = fw_carry_init(p.shape[1], torch.float32, *setup, em, prng.PRNGKey(cfg.seed),
                          private=private)
    kw = dict(loss="logistic", private=private)
    fw_scan_chunk(p, q, carry, LAM, em, 0.0, 0, None, steps=WARMUP, **kw)
    ms = sync_ms(lambda: fw_scan_chunk(p, q, carry, LAM, em, 0.0, WARMUP, None, steps=100,
                                       **kw)) / 100
    return dict(d=p.shape[1], per_step_ms=ms), (100, lambda: fw_scan_chunk(
        p, q, carry, LAM, em, 0.0, WARMUP + 100, None, steps=100, **kw))


def _alg1_window(X, y_t, cfg: FWConfig) -> tuple:
    """Per-step ms (host clock, 50 steps after 20) of ``cfg``'s Alg 1 on the
    design ``X``, and the next 50 steps as a callable."""
    step = _dense_step(X, y_t, cfg, masked=False)
    carry, _ = _dense_chunk(step, _carry0(X, X[0].shape[1], cfg), 0, 20, masked=False)
    ms = sync_ms(lambda: _dense_chunk(step, carry, 20, 50, masked=False)) / 50
    return dict(d=X[0].shape[1], per_step_ms=ms), (50, lambda: _dense_chunk(
        step, carry, 70, 50, masked=False))


def _profiled_windows(windows: dict) -> dict:
    """Device busy ms a step, idle share and spmv kernels' ms a step of each
    ``{name: (steps, fn)}`` window, all in one profiler session: each window
    runs inside its own ``record_function`` range and ends synchronised, and
    a kernel belongs to the window whose host-clock range holds its device
    start (the profiler puts both on one clock)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _profiler_warmup()
        for name, (_, fn) in windows.items():
            with torch.profiler.record_function(f"window:{name}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the ranges' host side (a range may also show on the device as an annotation)
    spans = {e.name[len("window:"):]: e.time_range for e in events
             if e.name.startswith("window:") and e.device_type != cuda}
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("window:")
               and WARMUP_KERNEL not in e.name]
    out = {}
    for name, (steps, _) in windows.items():
        span = spans[name]
        mine = [e for e in kernels if span.start <= e.time_range.start <= span.end]
        require(mine, f"profiled window {name}: no kernels in its range")
        busy = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        out[name] = dict(device_busy_ms_per_step=busy / steps,
                         device_idle_share=1.0 - busy * 1e3 / span.elapsed_us(),
                         spmv_device_ms_per_step={
                             k: sum(e.time_range.elapsed_us() for e in mine if k in e.name)
                             / 1e3 / steps for k in ("ell_rmatvec", "ell_matvec")})
    return out


def _screened_launches(cfg: FWConfig, rounds: list) -> dict:
    """The launches a screened run of T steps must make (``gap_tol`` = 0
    never stops it): Alg 2 one a step and the two setup sweeps; Alg 1 one of
    each product a step, the ȳ sweep of every pair it ran on, and α's two
    products at every round's query."""
    due, fired = len(rounds), sum(r["repacked"] for r in rounds)
    want = dict.fromkeys(("ell_matvec", "ell_rmatvec", "coord_update", "two_level_draw",
                          "flash_attention", "flash_attention_bwd", "two_level_draw_lanes",
                          "coord_update_lanes", "scatter_add_ordered"), 0)
    if cfg.backend == "torch_sparse":
        want.update(coord_update=cfg.steps, ell_rmatvec=2,
                    two_level_draw=cfg.steps if cfg.queue == "two_level" else 0)
    else:
        want.update(ell_matvec=cfg.steps + due, ell_rmatvec=cfg.steps + 1 + fired + due)
    return want


def _screened_run(run: str, pcsr, pcsc, y, steps: int) -> dict:
    """One screened solve on the card through ``solve``, with its rounds."""
    cfg = _screen_config(run, steps)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with obs.session() as tel, _recorded_rounds() as rec:
        t0 = time.perf_counter()
        res = solve((pcsr, pcsc), y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    rounds = [e["attrs"] for e in tel.events if e["name"] == "screen.round"]
    want = _screened_launches(cfg, rounds)
    require(counts == want, f"screen {run}: launches {counts}, expected {want}")
    # the launches on each repacked pair: from its round's commit to the next one's
    marks = rec.counts + [counts]
    pair_launches = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
    return dict(cfg=cfg, res=res, wall=wall, counts=counts, rounds=rounds, keeps=rec.keeps,
                sels=rec.sels, pair_launches=pair_launches,
                peak=torch.cuda.max_memory_allocated())


def phase_screen(X, y, y_t, pcsr, pcsc, cpu_pair) -> dict:
    """Screened solves at the rcv1.binary shape (T = 500, chunk 62, a round at
    each of the 8 interior boundaries): Alg 2 private and non-private, Alg 1
    ``argmax`` and ``gumbel``.  Each run's rounds (survivors, the new pair's
    bytes, the repack's and the owner table's ms on the card, the launches on
    each repacked pair), its per-step ms before and after the first round
    (fresh carries on the full pair and on the round-1 survivors), its wall
    against the unscreened config's and its peak memory.  Held: the
    coordinates equal the unscreened run's until the first round fires; w is
    D₀ long with ‖w‖₁ <= λ; at T = 200
    the card takes the CPU's coordinates and survivor sets (Alg 1 ``gumbel``:
    reported); a forced keep-all run equals its unscreened counterpart bit
    for bit.  Returns the round-1 survivor pairs of the Alg 2 private and
    Alg 1 ``argmax`` runs, for the kernels' repacked-pair times, and the
    before/after windows, which ``screen_busy`` profiles after every other
    profiled phase."""
    out, windows = {}, {}
    for run in SCREEN_RUNS:
        s = _screened_run(run, pcsr, pcsc, y, T_MAIN)
        cfg, res = s["cfg"], s["res"]
        base = _unscreened(cfg)
        t0 = time.perf_counter()
        ref = solve((pcsr, pcsc), y, base)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        first = next((r["round"] for r in s["rounds"] if r["repacked"]), None)
        require(first is not None, f"screen {run}: no round fired")
        prefix = first * SCREEN_CHUNK
        require(torch.equal(res.coords[:prefix], ref.coords[:prefix])
                and torch.equal(res.gaps[:prefix], ref.gaps[:prefix]),
                f"screen {run}: the run before its first round differs from the unscreened run")
        require(res.w.shape == (D,) and bool(torch.isfinite(res.w).all())
                and float(res.w.abs().sum()) <= LAM * (1 + 1e-5),
                f"screen {run}: w not D0 long, not finite, or outside the ball")
        support = set(torch.nonzero(res.w).flatten().tolist())
        require(support <= set(res.coords[res.coords >= 0].tolist()),
                f"screen {run}: supp(w) outside the selected coordinates")
        keep1 = s["keeps"][0] if first == 1 else None
        if keep1 is None:   # the first fired round came later: its survivors in original ids
            keep1 = np.zeros(D, bool)
            keep1[s["sels"][0]] = True
        t0 = time.perf_counter()
        survivors = screening.repack_pair(pcsr, pcsc, keep1)
        torch.cuda.synchronize()
        repack_ms = (time.perf_counter() - t0) * 1e3
        window = _alg2_window if cfg.backend == "torch_sparse" else _alg1_window
        before, windows[f"{run}/before"] = window((pcsr, pcsc), y_t, base)
        after, windows[f"{run}/after"] = window(survivors, y_t, base)
        rounds = [dict(round=r["round"], repacked=r["repacked"], survivors=r["survivors"],
                       dropped=r["dropped"], pair_bytes=r.get("pair_bytes"),
                       repack_ms=r.get("repack_seconds", 0.0) * 1e3,
                       owner_table_ms=r["owner_table_seconds"] * 1e3
                       if "owner_table_seconds" in r else None) for r in s["rounds"]]
        fired = [r["survivors"] for r in s["rounds"] if r["repacked"]]
        emit("screen", run=run, steps=T_MAIN, chunk=SCREEN_CHUNK, lam=LAM,
             epsilon=cfg.epsilon, solve_epsilon=base.epsilon, rounds=rounds,
             first_round=first, coords_equal_unscreened_until_step=prefix,
             solve_s=s["wall"], unscreened_solve_s=ref_wall,
             screened_over_unscreened=s["wall"] / ref_wall, launches=s["counts"],
             nnz_w=len(support), gap_last=float(res.gaps[-1]),
             round1_survivors=int(keep1.sum()),
             round1_nnz_share=int(survivors[0].nnz.sum()) / X.nnz,
             round1_repack_ms_sync=repack_ms,
             before_first_round=before, after_first_round=after,
             pair_launches=[dict(survivors=n, **{k: v for k, v in c.items() if v})
                            for n, c in zip(fired, s["pair_launches"])],
             max_memory_allocated=s["peak"], pair_bytes_full=screening.pair_bytes(
                 (pcsr, pcsc)))
        out[run] = dict(s, survivors=survivors, keep1=keep1)
    for run in ("torch_sparse_non_private", "alg1_gumbel"):
        out[run].pop("survivors")
    phase_screen_parity(y, pcsr, pcsc, cpu_pair)
    phase_screen_keep_all(pcsr, pcsc, y)
    torch.cuda.empty_cache()   # the keep-all runs held three copies of the pair
    return out, windows


def screen_busy(windows: dict) -> None:
    """Device busy a step and idle share of the ``screen`` phase's windows,
    before and after the first round, in one profiler session that comes
    after every other profiled phase (a session can cost later sessions
    recorded kernels: PERF.md §7)."""
    busy = _profiled_windows(windows)
    for run in SCREEN_RUNS:
        emit("screen_busy", run=run, before_first_round=busy[f"{run}/before"],
             after_first_round=busy[f"{run}/after"])


def phase_screen_parity(y, pcsr, pcsc, cpu_pair) -> None:
    """Screened runs on the card against the CPU's at T = 200 (3 rounds):
    coordinates and survivor sets equal, w and gaps within 1e-4, for Alg 2
    (both queues) and Alg 1 ``argmax``; Alg 1 ``gumbel``'s noise goes through
    torch's log/log1p, an ulp from the CPU's, so its differing steps are
    reported, as ``phase_alg1_parity`` reports them."""
    for run in SCREEN_RUNS:
        card = _screened_run(run, pcsr, pcsc, y, T_PARITY)
        cfg = _screen_config(run, T_PARITY, device="cpu")
        with _recorded_rounds() as rec:
            t0 = time.perf_counter()
            cpu = solve(cpu_pair, y, cfg)
            t_cpu = time.perf_counter() - t0
        differ = (card["res"].coords.cpu() != cpu.coords).nonzero().flatten().tolist()
        same_sets = len(card["sels"]) == len(rec.sels) and all(
            np.array_equal(a, b) for a, b in zip(card["sels"], rec.sels))
        fields = dict(run=f"screen_{run}", steps=T_PARITY, coords_equal=not differ,
                      differing_steps=[i + 1 for i in differ[:10]], survivor_sets_equal=same_sets,
                      survivors=[len(a) for a in card["sels"]], cpu_solve_s=t_cpu)
        if not differ:
            fields.update({f"max_abs_{k}": float((getattr(card["res"], k).cpu()
                                                  - getattr(cpu, k)).abs().max())
                           for k in ("w", "gaps")})
        emit("card_vs_cpu", **fields)
        if run != "alg1_gumbel":
            require(not differ and same_sets,
                    f"screen {run}: card/CPU coords or survivors differ: {fields}")
            require(fields["max_abs_w"] <= 1e-4 and fields["max_abs_gaps"] <= 1e-4,
                    f"screen {run}: card/CPU w or gaps differ: {fields}")


def phase_screen_keep_all(pcsr, pcsc, y) -> None:
    """Forced keep-all rounds at T = 200 (3 rounds, each repacking the whole
    pair on the card): each run equals its unscreened counterpart bit for bit."""
    for run in ("torch_sparse_private", "torch_sparse_non_private", "alg1_argmax"):
        cfg = _screen_config(run, T_PARITY)
        torch.cuda.reset_peak_memory_stats()
        with _keep_all(), obs.session() as tel:
            got = solve((pcsr, pcsc), y, cfg)
        peak = torch.cuda.max_memory_allocated()
        ref = solve((pcsr, pcsc), y, _unscreened(cfg))
        fired = [e["attrs"] for e in tel.events if e["name"] == "screen.round"]
        require(len(fired) == 3 and all(r["repacked"] and r["survivors"] == D for r in fired),
                f"screen keep-all {run}: rounds {fired}")
        for k in ("coords", "w", "gaps"):
            require(torch.equal(getattr(got, k), getattr(ref, k)),
                    f"screen keep-all {run}: {k} differs from the unscreened run")
        emit("screen_keep_all", run=run, steps=T_PARITY, rounds=len(fired),
             repack_ms=[r["repack_seconds"] * 1e3 for r in fired],
             owner_table_ms=[r.get("owner_table_seconds", 0.0) * 1e3 for r in fired],
             bitwise_equal_unscreened=True, max_memory_allocated=peak)


def repacked_kernel_times(y_t, screen: dict) -> dict:
    """Rows 1-4 on the round-1 survivor pairs: ``coord_update`` over the
    private screened run's columns of chunk 2 (which ran on that pair) and
    its bitwise rule there, the draw at the survivors' (G, M), and the spmv
    kernels on the Alg 1 ``argmax`` run's survivors; each with its plain
    version's time, its bound from the survivors' entries and, for the
    spmv kernels, ``torch.sparse.mm``'s.  Returns {kernel: fields}."""
    out = {}
    # ---- coord_update and the draw: the Alg 2 private run's survivors -------------
    priv = screen["torch_sparse_private"]
    p2, q2 = priv["survivors"]
    d2 = p2.shape[1]
    sel1 = np.flatnonzero(priv["keep1"])
    host2 = _host_csr(p2)
    csc2 = host2.tocsc()
    first = next(r["round"] for r in priv["rounds"] if r["repacked"])
    # the columns of the chunk after the first fired round, which ran on these survivors
    coords = priv["res"].coords.cpu().numpy()[first * SCREEN_CHUNK:(first + 1) * SCREEN_CHUNK]
    coords = np.searchsorted(sel1, coords[np.isin(coords, sel1)])
    cfg = _unscreened(priv["cfg"])
    em = em_scale_for(cfg, N)
    setup = fw_setup(p2, y_t, loss="logistic", pcsc=q2)
    group_size = tl_init(setup[2].abs() * em).group_size
    gaps = torch.zeros(len(coords), device=DEVICE)
    cds = torch.zeros(len(coords), dtype=torch.int32, device=DEVICE)
    scratch = coord_update_scratch(N, d2, DEVICE)
    js = torch.from_numpy(coords.astype(np.int32)).to(DEVICE)

    def replay(fn):
        st = _state_copy(fw_carry_init(d2, torch.float32, *setup, em, prng.PRNGKey(0),
                                       private=True))
        extra = {"scratch": scratch} if fn is coord_update else {}
        return [(lambda i=i: fn(js[i:i + 1], p2, q2, None, st["w"], st["w_m"], st["g_tilde"],
                                st["vbar"], st["qbar"], st["alpha"], st["queue"],
                                **_step_kwargs(st, "logistic", em, gaps, cds, i, float(i + 1)),
                                **extra)) for i in range(len(coords))]

    ms = device_ms(replay(coord_update))
    launches = replay(coord_update_ref)
    plain = sync_ms(lambda: [f() for f in launches]) / len(coords)
    # the kernel against its plain version on the same columns, each step from
    # the kernel's own state before it (and each side's queue rebuild after)
    st = _state_copy(fw_carry_init(d2, torch.float32, *setup, em, prng.PRNGKey(0), private=True))
    gk = torch.zeros(len(coords), device=DEVICE)
    ck = torch.zeros(len(coords), dtype=torch.int32, device=DEVICE)
    keys_out = ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha", "gaps", "coords", "prio",
                "group")
    worst = 0.0
    for i in range(len(coords)):
        sides = []
        for fn, s_, g_, c_ in ((coord_update, st, gk, ck),
                               (coord_update_ref, {k: v.clone() for k, v in st.items()},
                                gk.clone(), ck.clone())):
            _run_update(fn, js[i:i + 1], p2, q2, None, s_, "logistic", em, g_, c_, i, float(i + 1))
            sides.append([s_[k] for k in keys_out[:6]]
                         + [g_, c_.float(), s_["queue"].v, s_["queue"].c])
        for key, a, b in zip(keys_out, *sides):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"coord_update on the survivors, column {i}: {key} differs from plain")
            worst = max(worst, float((a - b).abs().max()))
    live = np.flatnonzero(np.diff(csc2.indptr) > 0)
    nnz2 = np.diff(csc2.indptr)
    buckets = {"head": int(np.argmax(nnz2)), "light": int(live[np.argmin(nnz2[live])])}
    routes = coord_update_bitwise(y_t, p2, q2, buckets, losses=("logistic",))
    b, by = bound(*_coord_update_bytes(host2, csc2, coords, group_size))
    # every launch on this pair in the private screened run, read from the counters
    on_pair = priv["pair_launches"][0]
    out["coord_update"] = dict(d=d2, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                               library_ms=None, columns=len(coords), bitwise_rule=True,
                               max_abs_err=worst, routes=routes,
                               launches=on_pair["coord_update"])
    # the draw at the survivors' (G, M), no touched groups
    state = tl_init(setup[2].abs() * em)
    _, keys = prng.key_chain(prng.PRNGKey(5), 200)
    draw_err = max(abs(int(two_level_draw(state.c, state.v, k))
                       - int(two_level_draw_ref(state.c, state.v, k))) for k in keys)
    require(draw_err == 0, "two_level_draw on the survivors differs from plain")
    j_out = torch.empty(1, dtype=torch.int32, device=DEVICE)
    ms = device_ms([lambda k=k: two_level_draw(state.c, state.v, k, out=j_out) for k in keys])
    plain = sync_ms(lambda: [two_level_draw_ref(state.c, state.v, k) for k in keys]) / len(keys)
    g, m = state.v.shape
    b, by = bound(4.0 * (2 * g + m + 1), 125.0 * (g + m) + 230.0)
    out["two_level_draw"] = dict(d=d2, groups=g, group_size=m, ms=ms, plain_ms=plain,
                                 bound_ms=b, bound_by=by, library_ms=None,
                                 max_abs_err=float(draw_err),
                                 launches=on_pair["two_level_draw"])
    # ---- the spmv kernels: the Alg 1 argmax run's survivors --------------------------
    a1 = screen["alg1_argmax"]
    p2, q2 = a1["survivors"]
    d2, nnz2 = p2.shape[1], int(p2.nnz.sum())
    q = torch.from_numpy(np.random.default_rng(2).normal(size=N).astype(np.float32)).to(DEVICE)
    w = a1["res"].w[torch.from_numpy(np.flatnonzero(a1["keep1"])).to(DEVICE)]
    host2 = _host_csr(p2)
    csc2 = host2.tocsc()
    on = lambda a, dt=None: torch.from_numpy(a if dt is None else a.astype(dt)).to(DEVICE)
    xt = torch.sparse_csr_tensor(on(csc2.indptr), on(csc2.indices), on(csc2.data, np.float32),
                                 size=(d2, N))
    xr = torch.sparse_csr_tensor(on(host2.indptr), on(host2.indices),
                                 on(host2.data, np.float32), size=(N, d2))
    r_got, r_ref = ell_rmatvec(p2, q, q2), ell_rmatvec_ref(p2.indices, p2.values, q, segments(p2))
    m_got, m_ref = ell_matvec(p2, w), ell_matvec_ref(p2.indices, p2.values, w)
    errs = {"ell_rmatvec": float((r_got - r_ref).abs().max()),
            "ell_matvec": float((m_got - m_ref).abs().max())}
    require(torch.equal(r_got.cpu(), ell_rmatvec_ref(*(t.cpu() for t in (p2.indices, p2.values,
                                                                        q)),
                                                     segments(p2.to("cpu")))),
            "ell_rmatvec on the survivors differs from its plain version on the CPU")
    require(errs["ell_matvec"] <= 1e-4 * max(1.0, float(m_ref.abs().max())),
            f"ell_matvec on the survivors differs from plain: {errs['ell_matvec']}")
    require(torch.allclose(torch.sparse.mm(xt, q[:, None])[:, 0], r_got, rtol=1e-4, atol=1e-5),
            "torch.sparse.mm disagrees with ell_rmatvec on the survivors")
    require(torch.allclose(torch.sparse.mm(xr, w[:, None])[:, 0], m_got, rtol=1e-4, atol=1e-5),
            "torch.sparse.mm disagrees with ell_matvec on the survivors")
    on_pair = a1["pair_launches"][0]   # the Alg 1 argmax run's launches on this pair
    for name, fn, plain_fn, lib_fn, nbytes in (
            ("ell_rmatvec", lambda: ell_rmatvec(p2, q, q2),
             lambda: ell_rmatvec_ref(p2.indices, p2.values, q, segments(p2)),
             lambda: torch.sparse.mm(xt, q[:, None]), 8.0 * nnz2 + 4.0 * N + 8.0 * d2),
            ("ell_matvec", lambda: ell_matvec(p2, w),
             lambda: ell_matvec_ref(p2.indices, p2.values, w),
             lambda: torch.sparse.mm(xr, w[:, None]), 8.0 * nnz2 + 8.0 * N + 4.0 * d2)):
        b, by = bound(nbytes, 2.0 * nnz2)
        out[name] = dict(d=d2, nnz=nnz2, ms=device_ms([fn] * 50),
                         plain_ms=device_ms([plain_fn] * 20), bound_ms=b, bound_by=by,
                         library_ms=device_ms([lib_fn] * 50), max_abs_err=errs[name],
                         launches=on_pair[name])
    emit("repacked_kernels", **out)
    return out


def phase_path(pcsr, pcsc, y) -> None:
    """``solve_path`` over λ = 50, 30, 20, 10 at T = 500 (budgets 500, 125,
    125, 125) for Alg 2 private and non-private and Alg 1 ``argmax``: per λ
    the stop step, last gap, nnz(w) and segment wall; the path's wall
    against four cold solves of the segments' configs, and against four
    cold solves at the full T (what a user without paths runs); segment 0
    equal to its
    cold solve bit for bit; ``ell_rmatvec`` twice for a whole Alg 2 path.
    Then a private path group of 8 configs (ε × seed) under ``plan="vmap"``
    (lanes) and ``"sequential"``, each config equal across the modes bit for
    bit."""
    pair = (pcsr, pcsc)
    for run in ("torch_sparse_private", "torch_sparse_non_private", "alg1_argmax"):
        cfg = FWConfig(lam=PATH_LAMS[0], lambdas=PATH_LAMS, steps=T_MAIN, loss="logistic",
                       epsilon=1.0, delta=1e-6, device=DEVICE, **SCREEN_RUNS[run])
        reset_launch_counts()
        with obs.session() as tel:
            t0 = time.perf_counter()
            path = solve_path(pair, y, config=cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        plan = path.plan
        total = plan.total_steps   # gap_tol = 0: every segment runs its budget
        want = dict.fromkeys(counts, 0)
        if cfg.backend == "torch_sparse":   # one setup: ell_rmatvec twice for the path
            want.update(coord_update=total, ell_rmatvec=2,
                        two_level_draw=total if cfg.queue == "two_level" else 0)
        else:   # Alg 1 builds its step, and ȳ, once a segment
            want.update(ell_matvec=total, ell_rmatvec=total + len(PATH_LAMS))
        require(counts == want, f"path {run}: launches {counts}, expected {want}")
        # four cold solves at the segments' budgets, and at the full T each
        cold, cold_s, full_s = [], [], []
        for k in range(len(PATH_LAMS)):
            seg = segment_config(cfg, plan, k)
            for out, c in ((cold_s, seg), (full_s, dataclasses.replace(seg, steps=T_MAIN))):
                t0 = time.perf_counter()
                res = solve(pair, y, c)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                if c is seg:
                    cold.append(res)
        require(all(torch.equal(getattr(path[0], k), getattr(cold[0], k))
                    for k in ("coords", "gaps", "w")),
                f"path {run}: segment 0 differs from its standalone solve")
        events = [e["attrs"] for e in tel.events if e["name"] == "path.lambda"]
        per_lambda = [dict(lam=lam, budget=plan.budgets[k], offset=plan.offsets[k],
                           eps_lambda=plan.eps_lambdas[k], stop_step=r.stop_step_or(),
                           stop_reason=r.stop_reason, gap_last=float(r.gaps_valid[-1]),
                           nnz_w=int((r.w != 0).sum()), segment_s=events[k]["seconds"],
                           cold_solve_s=cold_s[k],
                           cold_nnz_w=int((cold[k].w != 0).sum()),
                           cold_gap_last=float(cold[k].gaps[-1]))
                      for k, (lam, r) in enumerate(zip(PATH_LAMS, path))]
        require(all(bool(torch.isfinite(r.w).all()) and float(r.w.abs().sum())
                    <= PATH_LAMS[0] * (1 + 1e-5) for r in path), f"path {run}: bad w")
        emit("path", run=run, lambdas=list(PATH_LAMS), budgets=list(plan.budgets),
             total_steps=total, per_lambda=per_lambda, path_s=wall,
             cold_solves_s=sum(cold_s), path_over_cold=wall / sum(cold_s),
             cold_full_t_solves_s=sum(full_s), path_over_cold_full_t=wall / sum(full_s),
             launches=counts, segment0_bitwise_equal=True)
    cfgs = [FWConfig(backend="torch_sparse", queue="two_level", lam=PATH_LAMS[0],
                     lambdas=PATH_LAMS, steps=T_MAIN, loss="logistic", epsilon=eps, delta=1e-6,
                     seed=seed, device=DEVICE)
            for eps in PATH_GROUP_EPS for seed in PATH_GROUP_SEEDS]
    runs, results = {}, {}
    for mode in ("vmap", "sequential") * 2:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with obs.session() as tel:
            t0 = time.perf_counter()
            res = solve_many(pair, y, cfgs, plan=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        total = res[0].plan.total_steps
        span = [e["attrs"]["mode"] for e in tel.events
                if e["ev"] == "span" and e["name"] == "group.path"]
        require(span == ["fused" if mode == "vmap" else "sequential"],
                f"path group {mode}: spans {span}")
        want = dict.fromkeys(counts, 0)
        per, sfx = (1, "_lanes") if mode == "vmap" else (len(cfgs), "")
        want.update({"coord_update" + sfx: per * total, "two_level_draw" + sfx: per * total,
                     "ell_rmatvec": 2})
        require(counts == want, f"path group {mode}: launches {counts}, expected {want}")
        runs.setdefault(mode, []).append(dict(
            wall_s=wall, per_config_s=wall / len(cfgs),
            per_config_step_ms=wall * 1e3 / (len(cfgs) * total), launches=counts,
            wrapper_launches_per_step={k: v / total for k, v in counts.items() if v
                                       and k != "ell_rmatvec"},
            # coord_update is two kernels (rows, owners) a launch, the draw one
            device_kernels_per_step=(2 * counts["coord_update" + sfx]
                                     + counts["two_level_draw" + sfx]) / total,
            rebuild_only_launches=two_level_draw_lanes.rebuilds + two_level_draw.rebuilds,
            max_memory_allocated=torch.cuda.max_memory_allocated()))
        results.setdefault(mode, res)
    for i, (a, b) in enumerate(zip(results["vmap"], results["sequential"])):
        for k in range(len(PATH_LAMS)):
            _same_as_solve(a[k], b[k], f"path group config {i} segment {k}")
    emit("path_group", configs=len(cfgs), lambdas=list(PATH_LAMS),
         epsilons=list(PATH_GROUP_EPS), seeds=list(PATH_GROUP_SEEDS), vmap=runs["vmap"],
         sequential=runs["sequential"],
         lane_cost_ratio=runs["vmap"][-1]["wall_s"] / runs["sequential"][-1]["wall_s"],
         bitwise_equal_across_modes=True)


# ---------------------------------------------------------------------------
# the other engines (torch_dense, the oracle, host_sparse) and the fit service


def _alg2_config(backend: str, private: bool, **kw) -> FWConfig:
    base = dict(backend=backend, lam=LAM, steps=T_MAIN, loss="logistic", epsilon=1.0,
                delta=1e-6, queue="two_level" if private else "group_argmax", device=DEVICE)
    return FWConfig(**{**base, **kw})


def _tie_margin(pcsr, pcsc, y_t, private: bool, step: int, picks: tuple) -> float:
    """How near a tie the two coordinates ``picks`` were at ``step`` of
    ``torch_sparse``'s run (its card state after step - 1): the relative gap
    between their scores in the selection that split them — |α| for the exact
    argmax; for the private draw the group scores c + Gumbel, or, in one
    group, the members' v + Gumbel, with the step's noise."""
    cfg = _alg2_config("torch_sparse", private)
    em = em_scale_for(cfg, N)
    carry = fw_carry_init(D, torch.float32, *fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc),
                          em, prng.PRNGKey(0), private=private)
    fw_scan_chunk(pcsr, pcsc, carry, LAM, em, 0.0, 0, None, steps=step - 1, loss="logistic",
                  private=private)
    if private:
        q = carry.sampler
        kg, km = prng.split2(prng.key_chain(prng.PRNGKey(0), step)[1][-1])
        m = q.group_size
        groups = [p // m for p in picks]
        if groups[0] != groups[1]:
            scores, at = q.c + prng.gumbel(kg, q.c.shape, DEVICE), groups
        else:
            scores, at = q.v[groups[0]] + prng.gumbel(km, (m,), DEVICE), [p % m for p in picks]
    else:
        scores, at = carry.alpha.abs(), list(picks)
    a, b = (float(scores[i]) for i in at)
    return abs(a - b) / max(abs(a), abs(b))


def _agree(coords, w, gaps, ref, name: str, tie=None) -> dict:
    """``coords`` equal to ``ref``'s first len(coords); w (when given) and the
    gaps within 1e-4 (the cross-engine contract).  ``tie(step, picks)``, where
    given, admits a divergence that ``ROADMAP.md`` §C records (engines that
    round α differently): the first differing step must be a tie
    of its two picks within ``TIE_REL``, and the steps before it agree."""
    steps = coords.shape[0]
    differ = (coords.cpu() != ref.coords[:steps].cpu()).nonzero().flatten().tolist()
    upto = differ[0] if differ else steps
    fields = dict(steps=steps, coords_equal=not differ,
                  max_abs_gaps=float((gaps[:upto].cpu().double()
                                      - ref.gaps[:upto].cpu().double()).abs().max()))
    if differ:
        k = differ[0] + 1
        require(tie is not None, f"{name}: coords differ at steps {[i + 1 for i in differ[:5]]}")
        picks = (int(coords[k - 1]), int(ref.coords[k - 1]))
        margin = tie(k, picks)
        require(margin <= TIE_REL, f"{name}: diverges at step {k} where {picks} are no tie "
                f"(relative margin {margin})")
        fields.update(first_differing_step=k, picks=picks, tie_relative_margin=margin,
                      differing_steps=len(differ))
    elif w is not None:
        fields["max_abs_w"] = float((w.cpu().double() - ref.w.cpu().double()).abs().max())
    require(all(v <= 1e-4 for k, v in fields.items() if k.startswith("max_abs")),
            f"{name}: w or gaps differ: {fields}")
    return fields


def phase_engines(pcsr, pcsc, y, y_t, runs, cpu_pair) -> dict:
    """``torch_dense`` through ``solve(backend="jax_dense")`` at full width,
    private and non-private, T = 500: only ``ell_rmatvec`` (2, the setup),
    ``scatter_add_ordered`` (v̄, q̄ and α, three a step) and, private, the
    draw kernel's rebuild-only form once a step launch;
    coordinates equal to ``torch_sparse``'s card runs and to a CPU run of
    ``torch_dense`` (T = 500), w and gaps within 1e-4, or split from them
    with no tie admitted (the in-order scatter kernel adds as the CPU does),
    and w equal to the CPU's bit for bit; the CPU's run equal to
    ``torch_sparse``'s coordinates; a rerun equal bit for bit; per-step ms
    of both tiles; ``gap_tol`` runs stopped at the fixed-T run's first gap
    <= tol.  (Its profiled steps: ``engines_busy``.)"""
    t_phase = time.perf_counter()
    pair = (pcsr, pcsc)
    out = {}
    for private in (True, False):
        name = "private" if private else "non_private"
        cfg = _alg2_config("jax_dense", private)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(pair, y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, rebuilds = launch_counts(), two_level_draw.rebuilds
        peak = torch.cuda.max_memory_allocated()
        want = dict.fromkeys(counts, 0)
        want.update(ell_rmatvec=2, scatter_add_ordered=counts["scatter_add_ordered"])
        require(counts == want and 0 < counts["scatter_add_ordered"] <= 3 * T_MAIN,
                f"torch_dense {name}: launches {counts}, expected {want}")
        require(rebuilds == (T_MAIN if private else 0),
                f"torch_dense {name}: {rebuilds} rebuild-only launches")
        require(res.stop_step == T_MAIN and res.stop_reason == "max_steps",
                f"torch_dense {name}: stop {res.stop_step} {res.stop_reason}")
        vs_sparse = _agree(res.coords, res.w, res.gaps, runs[name]["res"],
                           f"torch_dense {name} against torch_sparse")
        again = solve(pair, y, cfg)
        require(all(torch.equal(getattr(again, k), getattr(res, k))
                    for k in ("w", "gaps", "coords")),
                f"torch_dense {name}: two runs differ (the scatter order is not fixed)")
        t0 = time.perf_counter()
        cpu = solve(cpu_pair, y, dataclasses.replace(cfg, device="cpu"))
        t_cpu = time.perf_counter() - t0
        vs_cpu = _agree(res.coords, res.w, res.gaps, cpu, f"torch_dense {name}: card against CPU")
        require(torch.equal(cpu.w, res.w.cpu()), f"torch_dense {name}: card w != CPU w")
        # the CPU's torch_dense against torch_sparse: one state machine, one order
        cpu_vs_sparse = _agree(cpu.coords, cpu.w, cpu.gaps, runs[name]["res"],
                               f"torch_dense {name} on the CPU against torch_sparse")
        vs_cpu.update(cpu_solve_s=t_cpu, w_bitwise_equal=bool(torch.equal(cpu.w, res.w.cpu())),
                      gaps_bitwise_equal=bool(torch.equal(cpu.gaps, res.gaps.cpu())))
        tile_ms = {tile: sync_ms(lambda: sparse_fw_torch(pcsr, pcsc, y_t, cfg, tile=tile))
                   / T_MAIN for tile in TILES}
        tol = _least_positive_half(res)
        reset_launch_counts()
        t0 = time.perf_counter()
        stopped = solve(pair, y, dataclasses.replace(cfg, gap_tol=tol))
        torch.cuda.synchronize()
        stop_fields = _stopped_prefix(stopped, res, tol, f"torch_dense {name} gap_tol")
        stop_fields.update(solve_s=time.perf_counter() - t0, launches=launch_counts())
        emit("engines", run=name, backend="torch_dense", requested="jax_dense", steps=T_MAIN,
             solve_s=wall, per_step_ms=wall * 1e3 / T_MAIN, launches=counts,
             rebuild_only_launches=rebuilds, max_memory_allocated=peak,
             vs_torch_sparse=vs_sparse, bitwise_equal_rerun=True, vs_cpu=vs_cpu,
             cpu_vs_torch_sparse=cpu_vs_sparse,
             per_step_ms_by_tile=tile_ms, default_tile=default_tile(private, DEVICE),
             gap_tol_run=stop_fields)
        out[name] = dict(counts=counts, rebuilds={"two_level_draw": rebuilds})
    emit("engines_done", seconds=time.perf_counter() - t_phase)
    return out


def engines_busy(pcsr, pcsc, y_t) -> None:
    """Device busy ms a step and idle share of 100 ``torch_dense`` steps
    (default tile) under the profiler, the run's last window."""
    for name in ("private", "non_private"):
        cfg = _alg2_config("torch_dense", name == "private", steps=100)
        prof = profile_steps(f"torch_dense_{name}", 100,
                             lambda: sparse_fw_torch(pcsr, pcsc, y_t, cfg), quiet=True)
        busy = sum(prof["by_kernel"].values())
        require(busy > 0, f"torch_dense {name}: the profiler recorded no device time")
        emit("engines_profile", run=name, steps=100, profiled_wall_ms=prof["wall_ms"],
             device_busy_ms_per_step=busy / 100, device_idle_share=1.0 - busy / prof["wall_ms"],
             kernels_per_step=sum(prof["calls"].values()) / 100,
             top_device=sorted(((k[:60], v) for k, v in prof["by_kernel"].items()),
                               key=lambda r: -r[1])[:6])


def phase_reference(pcsr, pcsc, y_t, runs, cpu_pair) -> dict:
    """The port's eager oracle ``reference_fw`` on the card at full width,
    T = 500, private and non-private: no kernel launches but the in-order
    scatter's; coordinates equal to its CPU run with no tie admitted and w
    equal bit for bit (the card's scatter adds as the CPU does); against
    ``torch_sparse``'s card runs, coordinates equal with no tie admitted,
    w and gaps within 1e-4 (one state machine and one α₀ formula; the
    oracle adds α₀ in row order, ``ell_rmatvec`` in segments of 256)."""
    t_phase = time.perf_counter()
    out = {}
    for private in (True, False):
        name = "private" if private else "non_private"
        em = em_scale_for(_alg2_config("torch_sparse", private), N)
        reset_launch_counts()
        t0 = time.perf_counter()
        w, gaps, coords = reference_fw(pcsr, pcsc, y_t, lam=LAM, steps=T_MAIN, private=private,
                                       em_scale=em, seed=0, loss="logistic")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        require(sum(counts.values()) == counts["scatter_add_ordered"] > 0
                and two_level_draw.rebuilds == 0,
                f"reference {name}: the oracle launched {counts}")
        t0 = time.perf_counter()
        cpu = FWResult(*reference_fw(*cpu_pair, y_t.cpu(), lam=LAM, steps=T_MAIN,
                                     private=private, em_scale=em, seed=0, loss="logistic"),
                       losses=None)
        cpu_s = time.perf_counter() - t0
        vs_cpu = _agree(coords, w, gaps, cpu, f"reference {name}: card against CPU")
        require(torch.equal(cpu.w, w.cpu()), f"reference {name}: card w != CPU w")
        vs_cpu.update(cpu_solve_s=cpu_s, w_bitwise_equal=True)
        fields = _agree(coords, w, gaps, runs[name]["res"], f"reference {name}")
        emit("reference", run=name, solve_s=wall, per_step_ms=wall * 1e3 / T_MAIN,
             launches=counts, vs_cpu=vs_cpu, **fields)
        out[name] = dict(counts=counts, rebuilds={})
    emit("reference_done", seconds=time.perf_counter() - t_phase)
    return out


def phase_host_sparse(X, y, pcsr, pcsc, y_t, runs) -> None:
    """``host_sparse``'s float64 host loop, non-private ``fib_heap``, on the
    host CSR: coordinates equal to ``torch_sparse``'s non-private card run,
    gaps within 1e-4; its wall and FLOP audit.  Then ``solve`` through the
    backend (50 steps): float32/int32 tensors on the card, the engine's."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    res = sparse_fw(X, y.astype(np.float64), lam=LAM, steps=T_HOST, queue="fib_heap")
    wall = time.perf_counter() - t0
    # float64 against float32 arithmetic: a tie may split them too (ROADMAP.md §C)
    fields = _agree(torch.from_numpy(res.coords), torch.from_numpy(res.w) if T_HOST == T_MAIN
                    else None, torch.from_numpy(res.gaps), runs["non_private"]["res"],
                    "host_sparse against torch_sparse",
                    lambda k, picks: _tie_margin(pcsr, pcsc, y_t, False, k, picks))
    reset_launch_counts()
    back = solve(X, y, FWConfig(backend="host_sparse", lam=LAM, steps=50, device=DEVICE))
    require(back.w.device.type == torch.device(DEVICE).type and back.coords.dtype == torch.int32
            and torch.equal(back.coords.cpu(), torch.from_numpy(res.coords[:50]).int()),
            "host_sparse through solve: not the engine's coords as int32 on the card")
    require(not any(launch_counts().values()), "host_sparse launched a kernel")
    emit("host_sparse", queue="fib_heap", wall_s=wall,
         per_step_ms=wall * 1e3 / T_HOST, flops=res.flops, queue_work=res.queue_work,
         pops=res.pops, nnz_w=int((res.w != 0).sum()), result_device=str(back.w.device),
         **fields)
    emit("host_sparse_done", seconds=time.perf_counter() - t_phase)


def _service_requests(runs) -> list:
    """(tenant, config) of the service phase, in submission order: a private
    λ × ε grid of 8 (acme), four non-private ``torch_sparse`` fits, one
    ``torch_dense``, one ``dense`` and one ``gap_tol`` fit (initech), then
    one fit over its tenant's budget (globex) and one ``max_seconds`` fit on
    ``torch_dense``: the last two are refused."""
    reqs = [("acme", c) for c in grid(_alg2_config("torch_sparse", True), lam=SWEEP_LAMS,
                                      epsilon=SWEEP_EPS)]
    reqs += [("initech", _alg2_config("torch_sparse", False, lam=lam)) for lam in SWEEP_LAMS]
    reqs += [("initech", _alg2_config("torch_dense", False)),
             ("initech", _alg1_config("argmax", T_MAIN)),
             ("initech", _alg2_config("torch_sparse", False,
                                      gap_tol=_least_positive_half(runs["non_private"]["res"]))),
             ("globex", _alg2_config("torch_sparse", True, epsilon=2.0)),
             ("initech", _alg2_config("torch_dense", False, max_seconds=60.0))]
    return reqs


def _accountants() -> dict:
    return {t: PrivacyAccountant(epsilon=e, delta=1e-6, total_steps=n)
            for t, (e, n) in SVC_BUDGETS.items()}


def phase_fit_service(pcsr, pcsc, y, runs) -> dict:
    """One ``FitService`` on the card's pair (slots 8, three tenants) drains
    the ``_service_requests`` stream: the two last refused and charged
    nothing, acme charged its grid's ε²-equivalent steps, the ledger exact,
    every answered request equal to its own ``solve`` bit for bit.  Requests/s,
    latency, and the launches of the run (a lane batch: one launch of each
    lane kernel a step)."""
    t_phase = time.perf_counter()
    pair = (pcsr, pcsc)
    reqs = _service_requests(runs)
    t0 = time.perf_counter()
    svc = FitService(pair, y, _accountants(), FitServiceConfig(slots=8, device=DEVICE))
    start_s = time.perf_counter() - t0
    for uid, (tenant, cfg) in enumerate(reqs):
        svc.submit(FitRequest(uid=uid, tenant=tenant, config=cfg))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    rebuilds = {"two_level_draw": two_level_draw.rebuilds,
                "two_level_draw_lanes": two_level_draw_lanes.rebuilds}
    peak = torch.cuda.max_memory_allocated()
    status = [r.status for r in done]
    last = len(reqs) - 2
    require(status == ["done"] * last + ["rejected"] * 2, f"fit service statuses {status}")
    require("budget exhausted" in done[last].reason and "max_seconds" in done[last + 1].reason,
            f"fit service refusals: {[done[last].reason, done[last + 1].reason]}")
    want_acme = sum(FitService._charged_steps(_accountants()["acme"], r.config)
                    for r in done[:8])
    spent = {t: a.spent_steps for t, a in svc.accountants.items()}
    require(spent == {"acme": want_acme, "globex": 0, "initech": 0},
            f"fit service charges {spent}, expected acme {want_acme}, the others 0")
    # the private grid is one batch of 8: one draw launch a step as lanes, or 8 in sequence
    require(counts["two_level_draw_lanes"] == T_MAIN or counts["two_level_draw"] == 8 * T_MAIN,
            f"fit service: the private batch launched {counts}")
    audit = svc.verify_ledger()
    require(all(rec["exact"] for rec in audit.values()), f"ledger audit {audit}")
    charges = [(e["tenant"], e["uid"], e["steps"]) for e in svc.ledger.entries
               if e["kind"] == "charge"]
    stats = svc.stats()
    for r in done[:last]:
        _same_as_solve(r.result, solve(pair, y, r.config), f"fit service request {r.uid}")
    emit("fit_service", requests=len(reqs), slots=8, tenants=sorted(SVC_BUDGETS),
         statuses=status, refusals={r.uid: r.reason[:90] for r in done if r.status == "rejected"},
         backends=[r.config.backend for r in done], charges=charges, spent_steps=spent,
         ledger=audit, batch_sizes=stats["batch_sizes"], service_start_s=start_s,
         drain_s=wall, requests_per_s=stats["throughput_fits_per_s"],
         latency_s=stats["latency_s"], launches=counts, rebuild_only_launches=rebuilds,
         lane_launches_per_step={k: counts[k] / T_MAIN for k in ("two_level_draw_lanes",
                                                                  "coord_update_lanes")},
         coerced_layouts=sorted(f"{k[0]}@{k[1]}" for k in svc._coerced),
         max_memory_allocated=peak, bitwise_equal_own_solve=True)
    emit("fit_service_done", seconds=time.perf_counter() - t_phase)
    return dict(counts=counts, rebuilds=rebuilds)


# ---------------------------------------------------------------------------
# the in-order scatter-add (C2), flash's padded head dims (C3), the sharded engine


def _ell_rows(X: HostCSR) -> tuple:
    """(indices (N, Kr) int64, values (N, Kr) float32, live (N, Kr) bool) of
    ``X``'s padded rows, on the host: the lanes of an Xᵀq scatter."""
    nnz = np.diff(X.indptr)
    kr = int(nnz.max())
    live = np.arange(kr)[None, :] < nnz[:, None]
    idx = np.zeros((X.shape[0], kr), np.int64)
    val = np.zeros((X.shape[0], kr), np.float32)
    idx[live], val[live] = X.indices, X.data.astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(live)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def _scatter_case(dst, idx, src, live) -> dict:
    """The kernel on the card against the plain version on the CPU, bit for
    bit, and the device ms of the kernel's wrapper (its sort included) and of
    ``index_put_(accumulate=True)`` over the live lanes (the library call)."""
    want = scatter_add_ordered_ref(dst, idx, src, live)
    t0 = time.perf_counter()
    scatter_add_ordered_ref(dst, idx, src, live)
    plain_ms = (time.perf_counter() - t0) * 1e3
    on = [t.to(DEVICE) for t in (dst, idx, src, live)]
    got = scatter_add_ordered(*on)
    bitwise = _bits_equal(got, want)
    require(bitwise, f"scatter_add_ordered: {int((got.cpu() != want).sum())} targets differ "
            "from the plain version")
    ms = device_ms([lambda: scatter_add_ordered(*on)] * 20)
    at, terms = on[1].reshape(-1)[on[3].reshape(-1)], on[2].reshape(-1)[on[3].reshape(-1)]
    lib = device_ms([lambda: on[0].clone().index_put_((at,), terms, accumulate=True)] * 20)
    lanes, n = idx.numel(), dst.numel()
    live_n = int(live.sum())
    b, by = bound(lanes * (idx.element_size() + src.element_size() + 1) + 8.0 * n, live_n)
    return dict(targets=n, lanes=lanes, live_lanes=live_n,
                longest_chain=int(torch.bincount(idx.reshape(-1)[live.reshape(-1)]).max()),
                bitwise_equal=bitwise, ms=ms, plain_cpu_ms=plain_ms, library_ms=lib,
                bound_ms=b, bound_by=by)


def phase_scatter_vs_plain(X: HostCSR) -> None:
    """``scatter_add_ordered`` on the card against its plain version on the
    CPU, bit for bit, at three shapes: the oracle's setup Xᵀq at the
    rcv1.binary shape, the head column's full tile (every row's lanes onto
    α), and random repeated targets."""
    g = np.random.default_rng(21)
    idx, val, live = _ell_rows(X)
    q = torch.from_numpy(g.standard_normal(N).astype(np.float32))
    gamma = torch.from_numpy((g.standard_normal(N) / N).astype(np.float32))
    alpha = torch.from_numpy(g.standard_normal(D).astype(np.float32) * 1e-3)
    k = 1 << 20
    rep = torch.from_numpy(np.minimum((g.pareto(0.7, size=k) * 2).astype(np.int64), 999))
    cases = {"setup_xtq": (torch.zeros(D), idx, val * q[:, None], live),
             "head_column_tile": (alpha, idx, gamma[:, None] * val, live),
             "random_repeated": (torch.from_numpy(g.standard_normal(1000).astype(np.float32)),
                                 rep, torch.from_numpy(g.standard_normal(k).astype(np.float32)),
                                 torch.from_numpy(g.random(k) < 0.9))}
    for name, args in cases.items():
        emit("scatter_vs_plain", case=name, **_scatter_case(*args))


def phase_flash_head_dims() -> None:
    """The card's flash kernel at head dims outside its table (zero-padded in
    the wrapper, the true scale passed in): hd 18, 24, 112 and (hd, hdv) =
    (192, 128), both dtypes, against the plain version within the current
    bounds; and the sha256 of hd 64's outputs on seeded inputs (unpadded: the
    same launch as before the padding existed)."""
    import hashlib
    for hd, hdv in FLASH_PAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(DEVICE).manual_seed(hd + hdv)
            kvh = 16 if hd != hdv else 4          # MLA: no GQA; the dense configs: G = 4
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                       for shape in ((2, 1024, 16, hd), (2, 1024, kvh, hd), (2, 1024, kvh, hdv)))
            reset_launch_counts()
            got = flash_attention(q, k, v)
            require(launch_counts()["flash_attention"] == 1 and got.shape == (2, 1024, 16, hdv),
                    f"flash ({hd}, {hdv}): {launch_counts()}, shape {tuple(got.shape)}")
            want = flash_attention_plain(q, k, v).float()
            diff = (got.float() - want).abs()
            tol = FLASH_TOL[dtype]
            ok = bool((diff <= tol + tol * want.abs()).all()) and bool(torch.isfinite(got).all())
            ulps = float(bf16_ulps(diff, want).max()) if dtype == torch.bfloat16 else None
            ok = ok and (ulps is None or ulps <= FLASH_BF16_ULPS)
            require(ok, f"flash ({hd}, {hdv}) {dtype}: max |d| {float(diff.max())}, "
                    f"bf16 ulps {ulps}")
            emit("flash_head_dims", hd=hd, hdv=hdv, dtype=str(dtype).replace("torch.", ""),
                 kernel_head_dim=pad_head_dims(q, k, v)[0].shape[-1],
                 max_abs_err=float(diff.max()), tolerance=tol,
                 max_bf16_ulps_of_scale=ulps)
    hashes = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(LM_B, 512, 32, 4, 64, dtype, seed=64)
        hashes[str(dtype).replace("torch.", "")] = hashlib.sha256(
            flash_attention(q, k, v).cpu().view(torch.int16 if dtype == torch.bfloat16
                                                else torch.int32).numpy().tobytes()).hexdigest()
    emit("flash_head_dims", hd=64, unpadded=True, sha256=hashes)


def _shard_config(private: bool, **kw) -> FWConfig:
    return FWConfig(**{**dict(backend="jax_shard", mesh=(1, 1), lam=LAM, steps=T_MAIN,
                              loss="logistic", epsilon=1.0, delta=1e-6, device=DEVICE,
                              queue="gumbel" if private else "argmax"), **kw})


def _spans(tel) -> dict:
    return {e["name"]: e["dur_s"] for e in tel.events if e["ev"] == "span"}


def _alpha_scatter_row(src: ShardSource, res, launches: int) -> dict:
    """The kernels line's row of ``scatter_add_ordered``: its device ms over
    the α-delta scatters of 40 of the 1×1 run's steps (the full padded tile,
    Kc × Kr lanes, live where the column's rows hold entries), against the
    plain version's CPU ms on the same inputs (copied to the host first, so
    only the plain scatters are timed), ``index_put_``'s ms and the bound of
    those inputs; ``max_abs_err`` is the largest |card − plain| over all 40,
    each of which must be equal bit for bit."""
    blk = src.local(1, 1, 0, 0, DEVICE)
    g = torch.Generator(DEVICE).manual_seed(5)
    cases = []
    for j in res.coords[:40].tolist():
        rows = blk.csc_rows[j].long()
        ok = blk.csc_vals[j] != 0
        cols = blk.csr_cols[rows].long()
        vals = torch.where(ok[:, None], blk.csr_vals[rows], 0.0)
        gsc = torch.randn(rows.shape[0], generator=g, device=DEVICE) / N
        cases.append((torch.zeros(D, device=DEVICE), cols, gsc[:, None] * vals, vals != 0))
    ms = device_ms([lambda c=c: scatter_add_ordered(*c) for c in cases])
    host = [tuple(t.cpu() for t in c) for c in cases]
    t0 = time.perf_counter()
    wants = [scatter_add_ordered_ref(*c) for c in host]
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    gots = [scatter_add_ordered(*c).cpu() for c in cases]
    differ = sum(not _bits_equal(got, want) for got, want in zip(gots, wants))
    err = max(float((got - want).abs().max()) for got, want in zip(gots, wants))
    require(differ == 0, f"scatter_add_ordered: {differ} of {len(cases)} α-delta scatters "
            f"differ from plain (max |d| {err})")
    live = [(c[1].reshape(-1)[c[3].reshape(-1)], c[2].reshape(-1)[c[3].reshape(-1)])
            for c in cases]
    lib = device_ms([lambda c=c, lv=lv: c[0].clone().index_put_((lv[0],), lv[1],
                                                                 accumulate=True)
                     for c, lv in zip(cases, live)])
    lanes = cases[0][1].numel()
    live_n = sum(int(lv[0].numel()) for lv in live) / len(live)
    b, by = bound(lanes * (8.0 + 4.0 + 1.0) + 8.0 * D, live_n)
    return dict(name="scatter_add_ordered", route="cuda",
                source="src/repro_torch/kernels/scatter/csrc/scatter_add_ordered.cu",
                replaces="none: no Pallas counterpart (the C2 repair; the order of "
                         "src/repro/distributed/fw_shard.py:228 .at[cols].add on the CPU)",
                launches=launches, max_abs_err=err, bitwise_equal_cases=len(cases) - differ,
                ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib,
                lanes=lanes, mean_live_lanes=live_n)


def phase_shard_1x1(X: HostCSR, y, refs, tie) -> dict:
    """``jax_shard`` at the rcv1.binary shape, T = 500, private and
    non-private, through ``solve(..., FWConfig(backend="jax_shard",
    mesh=(1, 1)))`` under an NCCL process group of one rank (every
    collective through ``torch.distributed``): setup ms, per-step ms over
    450 steps, solve wall, peak memory, launches a step by kernel, the idle
    share of 100 profiled steps; coordinates equal to the port's CPU run of
    the engine (w and gaps within 1e-4, bits reported), to the card's
    oracle ``distributed/reference.py`` (private), and to ``torch_sparse``'s
    card run (non-private; a split only at a ``TIE_REL`` tie: the engines
    round α₀ differently, ``jax_shard`` as one fused scatter of
    Xᵀ((q̄ − y)/n), ``torch_sparse`` as Xᵀq̄/n − Xᵀy/n).  Then
    ``compress_topk`` (which only ``distributed_fw`` reaches), private,
    T = ``TOPK_T``, on the card under the NCCL mesh against the CPU.
    Returns the kernels line's row of ``scatter_add_ordered``."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    y_pad = torch.from_numpy(y.astype(np.float32))       # N_pad = N on a 1×1 grid
    t0 = time.perf_counter()
    src = ShardSource.from_any(X)
    blocks = src.blocks(1, 1)
    build_s = time.perf_counter() - t0
    # the CPU runs first, with no process group (NCCL takes no host tensors)
    cpu_runs = {}
    for private in (True, False):
        t0 = time.perf_counter()
        cpu_runs[private] = (solve(src, y, _shard_config(private, device="cpu")),
                             time.perf_counter() - t0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        require(mesh.distributed and mesh.backend == "nccl", f"not an NCCL mesh: {mesh}")
        t0 = time.perf_counter()
        blk = src.local(1, 1, 0, 0, DEVICE)
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0
        emit("shard_layout", grid=[1, 1], kc=blocks.csc_rows.shape[-1],
             kr=blocks.csr_cols.shape[-1], tile_lanes=blocks.csc_rows.shape[-1]
             * blocks.csr_cols.shape[-1], block_bytes=sum(t.numel() * t.element_size()
                                                          for t in blk),
             host_build_s=build_s, copy_to_card_s=layout_s)
        y_loc = y_pad.to(DEVICE)
        setup = lambda: shard_setup(blk, y_loc, n=N, loss="logistic", mesh=mesh)
        setup()                                  # the NCCL communicators start here
        setup_ms = sync_ms(setup, reps=5)
        out, counts_by_run = {}, {}
        for private in (True, False):
            name = "private" if private else "non_private"
            cfg = _shard_config(private)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with obs.session() as tel:
                t0 = time.perf_counter()
                res = solve(src, y, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            spans = _spans(tel)
            with obs.session() as tel:
                solve(src, y, dataclasses.replace(cfg, steps=WARMUP))
            per_step = (spans["shard.scan"] - _spans(tel)["shard.scan"]) * 1e3 / (T_MAIN - WARMUP)
            require(counts["scatter_add_ordered"] == 1 + 3 * T_MAIN
                    and sum(counts.values()) == counts["scatter_add_ordered"],
                    f"jax_shard {name}: launches {counts}")
            require(res.stop_step == T_MAIN and bool(torch.isfinite(res.gaps).all()),
                    f"jax_shard {name}: stop {res.stop_step}, gaps finite "
                    f"{bool(torch.isfinite(res.gaps).all())}")
            cpu, cpu_s = cpu_runs[private]
            vs_cpu = _agree(res.coords, res.w, res.gaps, cpu, f"jax_shard {name}: card vs CPU")
            vs_cpu.update(cpu_solve_s=cpu_s, w_bitwise_equal=_bits_equal(res.w, cpu.w),
                          gaps_bitwise_equal=_bits_equal(res.gaps, cpu.gaps))
            fields = dict(vs_cpu=vs_cpu)
            if private:
                reset_launch_counts()
                t0 = time.perf_counter()
                w_o, gaps_o, coords_o = shard_reference.reference_fw(
                    blocks, y_pad, lam=LAM, steps=T_MAIN, selection="gumbel",
                    em_scale=shard_em_scale(cfg, N), seed=0, device=DEVICE)
                torch.cuda.synchronize()
                fields["vs_reference"] = _agree(
                    coords_o, w_o[:D], gaps_o, res, f"jax_shard {name}: card vs the oracle")
                fields["vs_reference"].update(oracle_s=time.perf_counter() - t0,
                                              oracle_launches=launch_counts())
            else:
                fields["vs_torch_sparse"] = _agree(
                    res.coords, res.w, res.gaps, refs[name]["res"],
                    f"jax_shard {name} against torch_sparse", tie)
            emit("shard_1x1", run=name, mesh=[1, 1], process_group="nccl", world_size=1,
                 steps=T_MAIN, setup_ms=setup_ms, per_step_ms=per_step,
                 window_steps=T_MAIN - WARMUP, solve_s=wall, spans_s=spans,
                 max_memory_allocated=peak, launches=counts,
                 launches_per_step={k: v / T_MAIN for k, v in counts.items() if v}, **fields)
            out[name] = res
            counts_by_run[name] = counts
        # the error-feedback top-k exchange: the card under the NCCL mesh, then the CPU
        tk_cfg = DistFWConfig(lam=LAM, steps=TOPK_T, selection="gumbel", compress_topk=TOPK_K,
                              epsilon=1.0, delta=1e-6)
        reset_launch_counts()
        t0 = time.perf_counter()
        w_k, gaps_k, coords_k, stop_k = distributed_fw(blocks, y_pad, tk_cfg, mesh)
        torch.cuda.synchronize()
        tk_wall = time.perf_counter() - t0
        tk_counts = launch_counts()
        require(tk_counts["scatter_add_ordered"] == 1 + 4 * TOPK_T
                and sum(tk_counts.values()) == tk_counts["scatter_add_ordered"]
                and int(stop_k) == TOPK_T and bool(torch.isfinite(gaps_k).all()),
                f"compress_topk: launches {tk_counts}, stop {int(stop_k)}")
        t0 = time.perf_counter()
        cw, cg, cc, _ = distributed_fw(blocks, y_pad, tk_cfg, device="cpu")
        tk_cpu_s = time.perf_counter() - t0
        vs_cpu = _agree(coords_k, w_k[:D], gaps_k, FWResult(cw[:D], cg, cc, losses=None),
                        "jax_shard compress_topk: card vs CPU")
        vs_cpu.update(cpu_solve_s=tk_cpu_s, w_bitwise_equal=_bits_equal(w_k, cw),
                      gaps_bitwise_equal=_bits_equal(gaps_k, cg))
        emit("shard_1x1_topk", mesh=[1, 1], process_group="nccl", compress_topk=TOPK_K,
             selection="gumbel", steps=TOPK_T, solve_s=tk_wall, launches=tk_counts,
             distinct_coords=len(set(coords_k.tolist())), vs_cpu=vs_cpu)
        # 100 profiled steps of the private run (the setup outside the window)
        cfg = _shard_config(True)
        state0 = setup()
        window = lambda: shard_scan(blk, y_loc, state0, lams=[LAM],
                                    em_scales=[shard_em_scale(cfg, N)], gap_tols=[0.0],
                                    keys=[prng.PRNGKey(0)], steps=100, shape=(N, D),
                                    selection="gumbel", mesh=mesh)
        window()
        prof = profile_steps("jax_shard_private", 100, window, quiet=True)
        busy = sum(prof["by_kernel"].values())
        require(busy > 0, "jax_shard: the profiler recorded no device time")
        emit("shard_profile", run="private", steps=100, profiled_wall_ms=prof["wall_ms"],
             device_busy_ms_per_step=busy / 100, device_idle_share=1.0 - busy / prof["wall_ms"],
             kernels_per_step=sum(prof["calls"].values()) / 100,
             top_device=sorted(((k[:60], v) for k, v in prof["by_kernel"].items()),
                               key=lambda r: -r[1])[:8])
        row = _alpha_scatter_row(src, out["non_private"],
                                 counts_by_run["private"]["scatter_add_ordered"])
    finally:
        dist.destroy_process_group()
    emit("shard_1x1_done", seconds=time.perf_counter() - t_phase)
    return dict(row=row, counts=counts_by_run)


def phase_shard_2x2_gloo() -> None:
    """``jax_shard`` on a 2×2 grid: four processes on the one card over gloo
    (NCCL takes one card a rank), at the rcv1.binary generator cut to
    N = 4,096, D = 8,192 and T = 200, private and non-private, held to the
    same grid run by four CPU processes: coordinates equal, w and gaps within
    1e-4, the four ranks' results equal.  Each rank builds its block, copies
    it to its device and joins the grid's subgroups before any solve
    (``prep_s``) and starts with a 2-step solve; ``per_step_ms`` is rank 0's
    ``shard.scan`` span over T, the setup its ``shard.setup`` span."""
    t_phase = time.perf_counter()
    opts = dict(mesh=(2, 2), backend="gloo", device="cuda", n=SHARD2_N, d=SHARD2_D,
                nnz=NNZ_PER_ROW, informative=INFORMATIVE, lam=LAM, steps=SHARD2_T,
                queues=["gumbel", "argmax"], seed=SEED)
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs = run_ranks(solve_rank, 4, backend="gloo", timeout_s=400,
                         args=({**opts, "device": device},))
        bits = [{q: {k: v for k, v in r.items() if not k.endswith("_s")}
                 for q, r in o["runs"].items()} for o in outs]
        require(all(b == bits[0] for b in bits), f"2x2 {device}: the ranks' results differ")
        runs[device] = (outs[0]["runs"], time.perf_counter() - t0,
                        [o["prep_s"] for o in outs])
    for queue in opts["queues"]:
        card, cpu = runs["cuda"][0][queue], runs["cpu"][0][queue]
        require(card["coords"] == cpu["coords"], f"2x2 {queue}: card and CPU coordinates differ")
        dw = float(np.abs(np.asarray(card["w"]) - np.asarray(cpu["w"])).max())
        dg = float(np.abs(np.asarray(card["gaps"]) - np.asarray(cpu["gaps"])).max())
        require(dw <= 1e-4 and dg <= 1e-4, f"2x2 {queue}: w {dw}, gaps {dg} over 1e-4")
        emit("shard_2x2_gloo", run=queue, mesh=[2, 2], ranks=4, process_group="gloo",
             n=SHARD2_N, d=SHARD2_D, steps=SHARD2_T, coords_equal_cpu=True, max_abs_w=dw,
             max_abs_gaps=dg, w_bitwise_equal=card["w"] == cpu["w"],
             solve_s=card["wall_s"], setup_ms=card["setup_s"] * 1e3,
             per_step_ms=card["scan_s"] * 1e3 / SHARD2_T, prep_s_by_rank=runs["cuda"][2],
             cpu_solve_s=cpu["wall_s"], cpu_per_step_ms=cpu["scan_s"] * 1e3 / SHARD2_T,
             nccl_world_over_1="not run: NCCL takes one card a "
             f"rank and {torch.cuda.device_count()} is visible")
    emit("shard_2x2_done", seconds=time.perf_counter() - t_phase,
         spawn_and_run_s={d: r[1] for d, r in runs.items()})


# ---------------------------------------------------------------------------
# the other decoder archs: dense at full depth, MLA and MoE cut in depth
# ---------------------------------------------------------------------------


class recorded_routes:
    """Within the block, each MoE layer's router probabilities and expert ids
    are kept, in call order (``moe_route`` wrapped)."""

    def __enter__(self) -> list:
        self.calls, self.route = [], model_common.moe_route

        def record(p, x, cfg):
            out = self.route(p, x, cfg)
            self.calls.append((out[0], out[2]))
            return out

        model_common.moe_route = record
        return self.calls

    def __exit__(self, *exc):
        model_common.moe_route = self.route


def _router_margins(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's relative gap between its k-th and (k+1)-th probability."""
    top = probs.topk(k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) / top[:, k - 1]


def route_split(got: list, want: list, k: int) -> dict:
    """Tokens whose expert sets differ between two runs of the same MoE
    layers, and the plain run's router margins at them."""
    require(len(got) == len(want), f"MoE calls {len(got)} against {len(want)}")
    split, margins = 0, []
    for (_, ids_a), (probs, ids_b) in zip(got, want):
        rows = (ids_a.sort(-1).values != ids_b.sort(-1).values).any(-1)
        split += int(rows.sum())
        margins += _router_margins(probs[rows], k).tolist()
    return dict(moe_calls=len(want), tokens=sum(int(p.shape[0]) for p, _ in want),
                tokens_split=split, split_margins=margins[:16],
                split_margin_max=max(margins) if margins else None,
                least_router_margin=min(float(_router_margins(p, k).min()) for p, _ in want),
                tie_rel=ROUTE_TIE_REL)


def _arch_cuts(arch: str, layers) -> dict:
    """The arch's cuts in its bf16 runs: {what: [published, run]}."""
    return {} if layers is None else {"n_layers": [get_model(arch).cfg.n_layers, layers]}


def _kernel_head_dim(cfg):
    """The flash kernel's head dim for the arch (None: no attention layer)."""
    if not _flash_calls(cfg):
        return None
    return padded_head_dim(cfg.hd + (cfg.rope_head_dim if cfg.use_mla else 0), cfg.vhd)


def _flash_calls(cfg) -> int:
    """Flash launches of one forward: one an attention layer; each encdec
    decoder layer runs two (causal self-attention, then cross-attention)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return sum(kind in "fla" for kind in cfg.pattern())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _lm_batch(cfg, batch: int, seq: int, frames: int = 0):
    """Tokens from ``lm_batches`` (seed 1); an encdec batch also takes
    seeded frames, ``frames`` of them (else ``seq``), in the config's dtype."""
    tokens = torch.from_numpy(next(lm_batches(cfg.vocab, batch, seq, seed=1))["tokens"]).long(
    ).to(DEVICE)
    if cfg.family != "encdec":
        return tokens
    gen = torch.Generator(DEVICE).manual_seed(3)
    return {"frames": torch.randn(batch, frames or seq, cfg.d_model, generator=gen,
                                  device=DEVICE).to(cfg.torch_dtype), "tokens": tokens}


def _first(batch, n: int):
    """The batch with its first ``n`` decoder tokens (the frames whole)."""
    if isinstance(batch, dict):
        return {**batch, "tokens": batch["tokens"][:, :n]}
    return batch[:, :n]


def _decode_vs_forward(api, p, batch) -> tuple:
    """Decode steps over the batch's first ARCH_DECODE tokens (encdec after
    ``prefill_cross`` on its frames) against the forward's last logits:
    (max |d|, the cache's groups)."""
    cfg, batch = api.cfg, _first(batch, ARCH_DECODE)
    toks = batch["tokens"] if isinstance(batch, dict) else batch
    last = api.forward(p, batch, last_only=True)
    if cfg.family == "encdec":       # max_len bounds the cross memory too
        cache = encdec.prefill_cross(p, api.init_cache(toks.shape[0], ENCDEC_F32_FRAMES),
                                     batch["frames"], cfg)
    else:
        cache = api.init_cache(toks.shape[0], ARCH_DECODE)
    for t in range(ARCH_DECODE):
        logits, cache = api.decode_step(p, cache, toks[:, t:t + 1], t)
    return float((logits - last).abs().max()), sorted(cache)


def _greedy_one(api, p, prompt, n_new: int) -> list:
    """One request's greedy decode through ``decode_step``, from a zero cache."""
    cache = api.init_cache(1, ARCH_MAX_LEN)
    toks = torch.from_numpy(prompt.astype(np.int64)).to(DEVICE)
    for t in range(len(prompt)):
        logits, cache = api.decode_step(p, cache, toks[t:t + 1, None], t)
    out = [int(logits[0, 0].argmax())]
    while len(out) < n_new:
        logits, cache = api.decode_step(p, cache, torch.tensor([[out[-1]]], device=DEVICE),
                                        len(prompt) + len(out) - 1)
        out.append(int(logits[0, 0].argmax()))
    return out


def _serve_requests(vocab: int, n: int) -> list:
    rng = np.random.default_rng(7)
    return [Request(uid=i, prompt=rng.integers(1, vocab, int(rng.integers(
        ARCH_PROMPT[0], ARCH_PROMPT[1] + 1))).astype(np.int32), max_new_tokens=ARCH_NEW)
        for i in range(n)]


def _serve_matches_one_request_decodes(arch: str, api, p) -> dict:
    """A recurrent family's engine (one request more than slots) against a
    one-request greedy decode of each request, in float32: token for token."""
    engine = ServingEngine(api, p, ServeConfig(slots=ARCH_SLOTS, max_len=ARCH_MAX_LEN))
    requests = _serve_requests(api.cfg.vocab, ARCH_SLOTS + 1)
    for req in requests:
        engine.submit(req)
    got = {r.uid: r.generated for r in engine.run()}
    for req in requests:
        want = _greedy_one(api, p, req.prompt, ARCH_NEW)
        require(got.get(req.uid) == want, f"{arch} f32 serving: request {req.uid}'s tokens "
                f"{got.get(req.uid)} against the one-request decode's {want}")
    return dict(requests=len(requests), slots=ARCH_SLOTS, prefills=engine.prefills,
                tokens_equal_one_request_decode=True,
                prompt_lengths=[len(r.prompt) for r in requests])


def _arch_parity(arch: str) -> None:
    """Float32 at a cut depth: the kernel forward against the plain forward
    (logits, top-1, every token's experts), or, with no attention layer
    (mamba), the card's forward against the CPU's; then decode == forward,
    and for the recurrent families the engine's tokens."""
    full = get_model(arch).cfg
    over = {"dtype": "float32", "n_layers": ARCH_F32_LAYERS, **ARCH_F32_OVERRIDES.get(arch, {})}
    reduced = {k: [getattr(full, k), v] for k, v in over.items() if k != "dtype"}
    api = get_model(arch, overrides=over)
    cfg = api.cfg
    b, seq = ARCH_F32_SHAPE.get(arch, (ARCH_F32_B, ARCH_F32_S))
    p = api.init(LM_SEED)
    batch = _lm_batch(cfg, b, seq, ENCDEC_F32_FRAMES)
    n_flash = _flash_calls(cfg)
    reset_launch_counts()
    with recorded_routes() as got_routes:
        got = api.forward(p, batch, last_only=True)
    launches, routes = launch_counts()["flash_attention"], dict(flash_attention.routes)
    require(launches == n_flash and routes == {"bf16_tensor_cores": 0,
                                               "f32_cuda_cores": n_flash},
            f"{arch} f32 forward: {launches} flash launches, routes {routes}")
    reset_launch_counts()
    if n_flash:
        reference = "plain attention on the card"
        with plain_attention(), recorded_routes() as want_routes:
            want = api.forward(p, batch, last_only=True)
    else:                       # no kernel on the path: the card against the CPU
        reference = "the CPU"
        cpu = get_model(arch, overrides=over, device="cpu")
        want = cpu.forward(_tree_to(p, "cpu"), _tree_to(batch, "cpu"), last_only=True).to(DEVICE)
        want_routes = []
    require(launch_counts()["flash_attention"] == 0, f"{arch}: the reference launched flash")
    require(got.shape == (b, 1, cfg.padded_vocab) and bool(torch.isfinite(got).all()),
            f"{arch} f32 logits {tuple(got.shape)} not finite or misshapen")
    routing = route_split(got_routes, want_routes, cfg.top_k) if cfg.n_experts else None
    require(routing is None or not routing["tokens_split"]
            or routing["split_margin_max"] < ROUTE_TIE_REL,
            f"{arch}: kernel and plain forwards route {routing and routing['tokens_split']} "
            f"tokens apart, router margins {routing and routing['split_margins']} (admitted "
            f"below {ROUTE_TIE_REL})")
    d = float((got - want).abs().max())
    top_equal = bool((got.argmax(-1) == want.argmax(-1)).all())
    require(d <= LOGITS_ATOL and top_equal, f"{arch} f32 forward against {reference}: logits "
            f"max |d| {d} (bound {LOGITS_ATOL}), top-1 equal {top_equal}")
    dd, cache = _decode_vs_forward(api, p, batch)
    decode_bound = ENCDEC_DECODE_ATOL if cfg.family == "encdec" else LOGITS_ATOL
    require(dd <= decode_bound, f"{arch} decode vs forward (f32) max |d| {dd} over "
            f"{decode_bound}")
    serving = (_serve_matches_one_request_decodes(arch, api, p)
               if cfg.family in RECURRENT_FAMILIES else None)
    emit("lm_archs", arch=arch, run="parity_float32", batch=b, seq=seq,
         frames=ENCDEC_F32_FRAMES if cfg.family == "encdec" else None,
         layers=cfg.n_layers, reduced=reduced, cache=cache, flash_launches=launches,
         routes=routes, kernel_head_dim=_kernel_head_dim(cfg), reference=reference,
         max_abs_logit_err=d, bound=LOGITS_ATOL, top1_equal=True, logit_std=float(want.std()),
         routing=routing, decode_tokens=ARCH_DECODE, decode_vs_forward_max_abs=dd,
         decode_bound=decode_bound, serving_float32=serving)


def _moe_layer_profile(api, params, tokens: int) -> dict:
    """One MoE layer at the forward's token count and full capacity, alone
    under the profiler: its device ms by part (the expert products are
    ``aten::bmm``, the router and the shared expert ``aten::mm``)."""
    gen = torch.Generator(DEVICE).manual_seed(5)
    h = torch.randn(tokens, api.cfg.d_model, generator=gen, device=DEVICE).to(
        api.cfg.torch_dtype)
    moe = params["blocks"][0]["moe"]
    prof = profile_steps("", 1, lambda: model_common.moe_apply(moe, h, api.cfg,
                                                               capacity=tokens), quiet=True)
    busy = sum(prof["by_kernel"].values())
    experts, mm = prof["by_op"].get("aten::bmm", 0.0), prof["by_op"].get("aten::mm", 0.0)
    return dict(layer_device_ms=busy, expert_bmm_ms=experts, router_and_shared_mm_ms=mm,
                dispatch_combine_ms=busy - experts - mm,
                dispatch_combine_share=(busy - experts - mm) / busy,
                buffer_rows=api.cfg.n_experts * tokens, live_rows=tokens * api.cfg.top_k)


def _ssm_scan_profile(api, params, batch: int, seq: int) -> dict:
    """One mamba layer at the forward's shape, alone under the profiler, and
    its selective scan (``_ssm_chunked``: dA, dBx, the log-step scans, y)
    alone on that layer's inputs: device ms, kernels, and the scan's bound
    (its inputs dt, x, B, C read once and y written once, float32)."""
    cfg = api.cfg
    gen = torch.Generator(DEVICE).manual_seed(6)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=DEVICE).to(cfg.torch_dtype)
    layer = params["blocks"][0]
    xc, _, _ = mamba._mixer_in(layer, x, cfg, None)
    dt, a, b_mat, c = mamba._ssm_inputs(layer, xc, cfg)
    xf = xc.float()
    h0 = torch.zeros(batch, cfg.d_inner, cfg.ssm_state, device=DEVICE)
    block = profile_steps("", 1, lambda: mamba.block_apply(layer, x, cfg), quiet=True,
                          device_only=True)
    scan = profile_steps("", 1, lambda: mamba._ssm_chunked(dt, xf, a, b_mat, c, h0),
                         quiet=True, device_only=True)
    layer_ms, scan_ms = sum(block["by_kernel"].values()), sum(scan["by_kernel"].values())
    tokens, di, n = batch * seq, cfg.d_inner, cfg.ssm_state
    bd, by = bound(4.0 * tokens * (3 * di + 2 * n), 6.0 * tokens * di * n)
    return dict(layer_device_ms=layer_ms, scan_device_ms=scan_ms,
                scan_share_of_layer=scan_ms / layer_ms, scan_kernels=sum(scan["calls"].values()),
                scan_bound_ms=bd, scan_bound_by=by)


def _arch_timing(arch: str, batch: int, seq: int, layers) -> tuple:
    """bf16 ``forward(last_only)`` at B x S: timed, its launches read, one
    forward profiled.  Returns (api, params, the forward's launches, fields)."""
    over = {} if layers is None else {"n_layers": layers}
    reduced = _arch_cuts(arch, layers)
    api = get_model(arch, overrides=over)
    cfg = api.cfg
    n_flash = _flash_calls(cfg)
    t0 = time.perf_counter()
    params = api.init(LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = ENCDEC_TIMING_FRAMES if cfg.family == "encdec" else 0
    inputs = _lm_batch(cfg, batch, seq, frames)
    fwd = lambda: api.forward(params, inputs, last_only=True)
    out = fwd()                                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first_ms = sync_ms(fwd)
    counts, routes = launch_counts(), dict(flash_attention.routes)
    want_counts = {name: 0 for name in counts}
    want_counts["flash_attention"] = n_flash
    require(counts == want_counts, f"{arch} bf16 forward launches {counts}")
    require(routes == {"bf16_tensor_cores": n_flash, "f32_cuda_cores": 0},
            f"{arch} bf16 forward routes {routes}")
    peak = torch.cuda.max_memory_allocated()
    # a forward of a second or more is timed once more (first_ms is the other reading)
    ms = sync_ms(fwd, reps=1 if first_ms >= 1e3 else 3)
    require(out.shape == (batch, 1, cfg.padded_vocab) and bool(torch.isfinite(out.float()).all()),
            f"{arch} bf16 logits not finite or misshapen")
    reset_launch_counts()
    t_prof = time.perf_counter()
    # the recurrent families' forwards launch 11,000-23,000 kernels, whose CPU ops took
    # the profiler ~24 s to parse for falcon-mamba: their forward records the device only
    recurrent = cfg.family in RECURRENT_FAMILIES
    with flash_shapes() as shapes:
        prof = profile_steps(f"lm_archs_{arch}_bf16", 1, fwd, device_only=recurrent)
    profile_s = time.perf_counter() - t_prof
    require(launch_counts()["flash_attention"] == n_flash == sum(shapes.launches.values()),
            f"{arch} profiled forward: {launch_counts()['flash_attention']} flash launches")
    flash = {k: v for k, v in prof["by_kernel"].items() if "flash_fwd" in k}
    flash_calls = sum(c for k, c in prof["calls"].items() if "flash_fwd" in k)
    # the wrappers launched n_flash (above); the profiler may drop a record
    require((sum(flash.values()) > 0 if n_flash else not flash) and all("mma" in k for k in flash)
            and max(n_flash - 1, 0) <= flash_calls <= n_flash,
            f"{arch} profiled flash kernels {list(flash)}, {flash_calls} calls")
    busy = sum(prof["by_kernel"].values())
    fields = dict(forward_ms=ms, first_forward_ms=first_ms, tokens_per_s=batch * seq / ms * 1e3,
                  max_memory_allocated=peak, init_s=init_s, profile_s=profile_s,
                  launches=counts, routes=routes,
                  kernel_head_dim=_kernel_head_dim(cfg), device_busy_ms=busy,
                  device_kernels=sum(prof["calls"].values()),
                  flash_device_ms=sum(flash.values()), flash_profiled_calls=flash_calls,
                  flash_share_of_busy=sum(flash.values()) / busy,
                  # the expert products, and the last position's logits (a sliced x @ head)
                  bmm_device_ms=None if recurrent else prof["by_op"].get("aten::bmm", 0.0),
                  flash_launches_by_shape=[dict(b=b, sq=sq, sk=sk, causal=c, window=w,
                                                launches=n)
                                           for (b, sq, sk, c, w), n in shapes.launches.items()])
    if cfg.n_experts:
        fields["moe_layer"] = _moe_layer_profile(api, params, batch * seq)
    if cfg.family == "ssm":
        scan = _ssm_scan_profile(api, params, batch, seq)
        scan["scan_share_of_forward_busy"] = cfg.n_layers * scan["scan_device_ms"] / busy
        fields["ssm_layer"] = scan
    if cfg.family == "encdec":
        fields["frames"] = frames
    emit("lm_archs", arch=arch, run="timing_bfloat16", batch=batch, seq=seq,
         layers=cfg.n_layers, reduced=reduced, **fields)
    return api, params, counts, fields


def _arch_serve(arch: str, api, params, cuts: dict) -> None:
    """The serving engine: ARCH_REQUESTS requests on ARCH_SLOTS slots (the
    recurrent families one more, so a slot is reused)."""
    engine = ServingEngine(api, params, ServeConfig(slots=ARCH_SLOTS, max_len=ARCH_MAX_LEN))
    times = _timed_engine(engine)
    n = ARCH_REQUESTS + int(api.cfg.family in RECURRENT_FAMILIES)
    for req in _serve_requests(api.cfg.vocab, n):
        engine.submit(req)
    reset_launch_counts()
    t0 = time.perf_counter()
    finished = engine.run()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    require(len(finished) == n and all(len(r.generated) == ARCH_NEW for r in finished),
            f"{arch} serving: not every request got its {ARCH_NEW} tokens")
    require(all(0 <= t < api.cfg.padded_vocab for r in finished for t in r.generated),
            f"{arch} serving: a token out of the vocabulary")
    toks = torch.ones(ARCH_SLOTS, 1, dtype=torch.int64, device=DEVICE)
    pos = torch.full((ARCH_SLOTS,), 100, dtype=torch.int64, device=DEVICE)
    prof = profile_steps("", 2, lambda: [api.decode_step(params, engine.cache, toks, pos)
                                         for _ in range(2)], quiet=True, device_only=True)
    gen = sum(len(r.generated) for r in finished)
    emit("lm_archs", arch=arch, run="serve_bfloat16", layers=api.cfg.n_layers,
         reduced=cuts, slots=ARCH_SLOTS, max_len=ARCH_MAX_LEN, requests=n,
         new_tokens=ARCH_NEW,
         cache={g: sorted(b) for g, b in engine.cache.items()}, wall_s=wall,
         generated_tokens=gen, tokens_per_s=gen / wall, decode_steps=engine.steps,
         decode_step_ms=float(np.mean(times["decode"])) * 1e3, prefills=engine.prefills,
         prefill_ms=float(np.mean(times["prefill"])) * 1e3, launches=counts,
         device_kernels_per_decode_step=sum(prof["calls"].values()) / 2,
         device_busy_ms_per_decode_step=sum(prof["by_kernel"].values()) / 2,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         vocab_rule="0 <= token < padded_vocab (random weights score the padding too)")


def _encdec_decode(arch: str, api, params, cuts: dict) -> None:
    """No engine serves encdec: ``prefill_cross`` on ARCH_SLOTS rows of
    ENCDEC_FRAMES frames, then ENCDEC_STEPS greedy decode steps of all rows,
    each timed to a synchronise."""
    cfg = api.cfg
    gen = torch.Generator(DEVICE).manual_seed(8)
    frames = torch.randn(ARCH_SLOTS, ENCDEC_FRAMES, cfg.d_model, generator=gen,
                         device=DEVICE).to(cfg.torch_dtype)
    cache = api.init_cache(ARCH_SLOTS, ARCH_MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prefill_ms = sync_ms(lambda: encdec.prefill_cross(params, cache, frames, cfg))
    prefill_launches = launch_counts()["flash_attention"]
    require(prefill_launches == cfg.enc_layers,
            f"{arch} prefill_cross: {prefill_launches} flash launches")
    tok = torch.ones(ARCH_SLOTS, 1, dtype=torch.int64, device=DEVICE)
    step_ms, out = [], []
    for t in range(ENCDEC_STEPS):
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, t)
        tok = logits.argmax(-1)
        out.append(tok)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = torch.cat(out, dim=1)
    require(out.shape == (ARCH_SLOTS, ENCDEC_STEPS) and bool(((out >= 0) & (
        out < cfg.padded_vocab)).all()), f"{arch} decode: a token out of the vocabulary")
    pos = torch.full((ARCH_SLOTS,), ENCDEC_STEPS, dtype=torch.int64, device=DEVICE)
    prof = profile_steps("", 2, lambda: [api.decode_step(params, cache, tok, pos)
                                         for _ in range(2)], quiet=True, device_only=True)
    emit("lm_archs", arch=arch, run="decode_bfloat16", layers=cfg.n_layers, reduced=cuts,
         rows=ARCH_SLOTS, frames=ENCDEC_FRAMES, max_len=ARCH_MAX_LEN, steps=ENCDEC_STEPS,
         prefill_cross_ms=prefill_ms, prefill_cross_flash_launches=prefill_launches,
         decode_step_ms=float(np.mean(step_ms[1:])), first_decode_step_ms=step_ms[0],
         tokens_per_s=ARCH_SLOTS * (ENCDEC_STEPS - 1) / sum(step_ms[1:]) * 1e3,
         decode_flash_launches=launch_counts()["flash_attention"] - prefill_launches,
         device_kernels_per_decode_step=sum(prof["calls"].values()) / 2,
         device_busy_ms_per_decode_step=sum(prof["by_kernel"].values()) / 2,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         engine="none: the engine refuses encdec (no slot axis for the cross memory)")


def phase_lm_archs() -> dict:
    """Each arch in turn, alone on the card: float32 parity, bf16 forward
    timing, serving (encdec: timed decode steps); each model freed before the
    next.  Returns each arch's bf16 forward shape and launches."""
    t_phase = time.perf_counter()
    out = {}
    for arch, (batch, seq, layers) in LM_ARCHS.items():
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        _arch_parity(arch)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        api, params, counts, fields = _arch_timing(arch, batch, seq, layers)
        t2 = time.perf_counter()
        serve = _encdec_decode if api.cfg.family == "encdec" else _arch_serve
        serve(arch, api, params, _arch_cuts(arch, layers))
        out[arch] = dict(batch=batch, seq=seq, counts=counts, fields=fields)
        del api, params
        gc.collect()
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        emit("lm_archs_done", arch=arch, seconds=t3 - t0, parity_s=t1 - t0, timing_s=t2 - t1,
             serve_s=t3 - t2)
    emit("lm_archs_phase", seconds=time.perf_counter() - t_phase)
    return out


def sdpa_backends(sdpa) -> dict:
    """Device ms of each SDPA backend that takes these inputs, forced one at a
    time: the default call runs one of them, and its ``library_ms`` names it
    (the profiler recorded no kernel of these SDPA calls, twice)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ms = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa()
                ms[backend.name] = device_ms([sdpa] * 5)
        except RuntimeError:          # the backend does not take these inputs
            pass
    return ms


def _window_mask(sq: int, sk: int, window: int) -> torch.Tensor:
    """SDPA's boolean mask for causal attention within a trailing window."""
    d = torch.arange(sq, device=DEVICE)[:, None] - torch.arange(sk, device=DEVICE)[None, :]
    return (d >= 0) & (d < window)


# flash rows at the other archs' shapes (bf16, tensor cores): name, arch, its shape (B and
# S from the arch's bf16 forward unless given), causal, window
ARCH_FLASH_ROWS = (
    ("flash_attention_mla", "deepseek-v2-236b", {}, True, 0),
    ("flash_attention_hd112", "kimi-k2-1t-a32b", {}, True, 0),
    # recurrentgemma's local attention: window 2,048 over its S = 4,096, MQA at hd 256
    ("flash_attention_window2048", "recurrentgemma-2b", {}, True, 2048),
    # seamless' cross-attention: its tokens against its frames (S_q != S_k)
    ("flash_attention_cross", "seamless-m4t-medium", {"sk": ENCDEC_TIMING_FRAMES}, False, 0),
)


def arch_flash_rows(archs: dict) -> list:
    """Flash (bf16, tensor cores) at MLA's (192, 128) head dims (H = KV =
    128), kimi-k2's 112 (H = 64, KV = 8), recurrentgemma's local attention
    (H = 10, KV = 1, hd 256, window 2,048) and seamless' cross-attention
    (its 1,024 tokens against its 1,536 frames, 16 heads of 64), each at its
    arch's bf16 forward's shape, on seeded inputs: against the plain version
    within the bounds, timed against the bound of the unpadded work over the
    keys each query sees and against SDPA (and each SDPA backend that takes
    the inputs; a window goes to SDPA as a boolean mask); ``launches``: that
    forward's flash launches at the row's shape."""
    rows = []
    for name, arch, shape, causal, window in ARCH_FLASH_ROWS:
        cfg, run = get_model(arch).cfg, archs[arch]
        b, sq = shape.get("b", run["batch"]), shape.get("sq", run["seq"])
        sk, h, kv = shape.get("sk", sq), cfg.n_heads, cfg.n_kv_heads
        launches = sum(r["launches"] for r in run["fields"]["flash_launches_by_shape"]
                       if (r["b"], r["sq"], r["sk"], r["causal"], r["window"])
                       == (b, sq, sk, causal, window))
        require(launches > 0, f"{name}: the {arch} forward ran no flash at {(b, sq, sk)}")
        hd, hdv = cfg.hd + (cfg.rope_head_dim if cfg.use_mla else 0), cfg.vhd
        gen = torch.Generator(DEVICE).manual_seed(hd + hdv + h)
        q, k, v = (torch.randn(dims, generator=gen, device=DEVICE).to(torch.bfloat16)
                   for dims in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv)))
        flash = lambda: flash_attention(q, k, v, causal=causal, window=window)
        plain_fn = lambda: flash_attention_plain(q, k, v, causal=causal, window=window,
                                                 block_k=plain_block_k(sk))
        got, want = flash(), plain_fn().float()
        diff = (got.float() - want).abs()
        tol = FLASH_TOL[torch.bfloat16]
        ulps = float(bf16_ulps(diff, want).max())
        require(bool((diff <= tol + tol * want.abs()).all()) and ulps <= FLASH_BF16_ULPS
                and bool(torch.isfinite(got).all()),
                f"{name}: max |d| {float(diff.max())}, {ulps} bf16 ulps of scale")
        ms = device_ms([flash] * 10)
        plain = device_ms([plain_fn] * 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = _window_mask(sq, sk, window) if window else None
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window, enable_gqa=h != kv)
        lib_out = sdpa().transpose(1, 2)
        require(bool(((lib_out.float() - got.float()).abs() <= tol).all()),
                f"scaled_dot_product_attention disagrees with {name}")
        lib = device_ms([sdpa] * 10)
        ops = attention_ops(b, sq, sk, h, (hd + hdv) / 2, causal, window)
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + b * sq * h * hdv)
        bd, by = bound(nbytes, ops, BF16_OPS_PER_S)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/kernels/flash_attention/csrc/"
                         "flash_attention_mma.cu",
                         replaces="src/repro/kernels/flash_attention/kernel.py:106",
                         launches=launches,
                         max_abs_err=float(diff.max()), ms=ms, plain_ms=plain, bound_ms=bd,
                         bound_by=by, library_ms=lib, library_ms_by_backend=sdpa_backends(sdpa),
                         shape=dict(arch=arch, b=b, sq=sq, sk=sk, h=h, kv=kv, hd=hd, hdv=hdv,
                                    causal=causal, window=window),
                         kernel_head_dim=padded_head_dim(hd, hdv), max_bf16_ulps_of_scale=ulps,
                         tflop_per_s=ops / ms / 1e9))
        del q, k, v, qt, kt, vt, lib_out, got, want, diff, mask
    return rows


# ---------------------------------------------------------------------------
# lm_train: training on the card (flash attention's backward kernel, lm_loss,
# the optimizers, the trainer, the loader, the checkpointer, launch/train.py)
# ---------------------------------------------------------------------------

# tinyllama-1.1b at full width and depth through launch.train.train_lm: B x S tokens a
# step, steps, lr (cosine after max(steps // 20, 5) warm-up steps), the steps profiled
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR, TRAIN_PROFILED = \
    "tinyllama-1.1b", 8, 2048, 30, 1e-3, 3
# the JAX package's learning criterion (tests/test_trainer_data.py): the mean loss of
# the last 5 steps at least this far below the first 5's
TRAIN_LOSS_FALL = 0.3
# card against CPU, float32, the same weights: tinyllama at 2 of 22 layers, full width,
# B x S; bounds set before the first run: the loss within 1e-5 (relative), grad_norm
# within 1e-4 (relative), each gradient leaf's max |card - cpu| within 5e-4 of its max
# |cpu| (cuBLAS and the kernels sum in other orders than the CPU)
TRAIN_F32_LAYERS, TRAIN_F32_B, TRAIN_F32_S = 2, 1, 256
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GNORM_RTOL, TRAIN_F32_GRAD_REL = 1e-5, 1e-4, 5e-4
# resume (bf16, the same 2-layer shape): 6 steps straight against 3, save, restore, 3;
# the params equal bit for bit (a leaf that is not is named, and then held to 1e-6 of
# its norm)
RESUME_STEPS, RESUME_REL = 6, 1e-6
# the backward kernel against its plain version, bounds set before its first run:
# float32 max |kernel - plain| <= 2e-5 max |plain| (float32 sums in other orders);
# bf16 FLASH_TOL and FLASH_BF16_ULPS, the forward's two bounds, the spacings taken at
# max(|plain|, the row's RMS over hd, the tensor's RMS): a gradient row whose terms
# cancel (a causal first query's dq) is ~0 in both, apart by float32 rounding of terms
# of the tensor's size
BWD_F32_REL = 2e-5
# (name, arch, B, S_q, S_k, causal, window, dtype): tinyllama's training shape in both
# dtypes, then the other families' at their training runs' shapes
BWD_ROWS = (
    ("flash_attention_bwd", "tinyllama-1.1b", 8, 2048, 2048, True, 0, torch.bfloat16),
    ("flash_attention_bwd_f32", "tinyllama-1.1b", 8, 2048, 2048, True, 0, torch.float32),
    ("flash_attention_bwd_mla", "deepseek-v2-236b", 1, 2048, 2048, True, 0, torch.bfloat16),
    ("flash_attention_bwd_hd112", "kimi-k2-1t-a32b", 1, 1024, 1024, True, 0, torch.bfloat16),
    ("flash_attention_bwd_window2048", "recurrentgemma-2b", 1, 4096, 4096, True, 2048,
     torch.bfloat16),
    ("flash_attention_bwd_cross", "seamless-m4t-medium", 4, 1024, 1536, False, 0,
     torch.bfloat16),
)
# the other families, full width at a cut depth, each with its config's optimizer:
# (overrides, B, S, frames, steps); deepseek at capacity_factor 1.25 (96 slots an expert);
# kimi-k2 (1 + 1 layers, 64 of its 384 experts kept, as in its float32 parity run) so
# that the hd-112 backward row has a training run at its shape
TRAIN_FAMILIES = {
    "deepseek-v2-236b": ({"n_layers": 2, "capacity_factor": 1.25}, 1, 2048, 0, 2),
    "kimi-k2-1t-a32b": ({"n_layers": 2, "n_experts": 64}, 1, 1024, 0, 2),
    "falcon-mamba-7b": ({"n_layers": 2}, 1, 2048, 0, 2),
    "recurrentgemma-2b": ({"n_layers": 3}, 1, 4096, 0, 2),
    "seamless-m4t-medium": ({"n_layers": 4, "enc_layers": 2, "dec_layers": 2}, 4, 1024,
                            ENCDEC_TIMING_FRAMES, 2),
}
# train_lasso at paper_lasso.DATASETS["rcv1"], epsilon 1, T
LASSO_T = 500


def _train_args(arch: str, b: int, s: int, steps: int, **kw):
    import argparse
    base = dict(arch=arch, smoke=False, device=DEVICE, steps=steps, batch=b, seq=s,
                lr=TRAIN_LR, microbatches=1, seed=0, ckpt_dir=None, ckpt_every=10 ** 9,
                resume=False, dataset="rcv1", lam=LAM, epsilon=1.0, out=None)
    base.update(kw)
    return argparse.Namespace(**base)


class bwd_shapes:
    """Within the block, each backward launch of the attention op is tallied by
    its shape and dtype (B, S_q, S_k, causal, window, dtype)."""

    def __enter__(self):
        self.launches = {}
        self.bwd = bwd = fa_ops.flash_attention_bwd

        def tally(q, k, v, out, dout, lse, *, causal=True, window=0):
            # the wrapper counts on the module's name, which is this function
            # inside the block: its counts are carried back to the wrapper's
            tally.launches, tally.routes = 0, dict.fromkeys(bwd.routes, 0)
            got = bwd(q, k, v, out, dout, lse, causal=causal, window=window)
            bwd.launches += tally.launches
            for route, n in tally.routes.items():
                bwd.routes[route] += n
            key = (q.shape[0], q.shape[1], k.shape[1], causal, window, q.dtype)
            self.launches[key] = self.launches.get(key, 0) + tally.launches
            return got

        fa_ops.flash_attention_bwd = tally
        return self

    def __exit__(self, *exc):
        fa_ops.flash_attention_bwd = self.bwd


def _bwd_errors(grads, want, dtype) -> dict:
    """max |d| of dq, dk, dv against the plain version, each held to its bound."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        w = w.float()
        diff = (g.float() - w).abs()
        ref = float(w.abs().max())
        require(bool(torch.isfinite(g).all()), f"backward {name}: non-finite")
        if dtype == torch.float32:
            require(float(diff.max()) <= BWD_F32_REL * ref,
                    f"backward {name}: max |d| {float(diff.max())} > {BWD_F32_REL} x {ref}")
            out[name] = dict(max_abs_err=float(diff.max()), max_abs_plain=ref)
        else:
            tol = FLASH_TOL[torch.bfloat16]
            scale = torch.maximum(torch.maximum(w.abs(), w.pow(2).mean(-1, keepdim=True).sqrt()),
                                  w.pow(2).mean().sqrt())
            ulps = float((diff / (torch.finfo(torch.bfloat16).eps * scale)).max())
            require(bool((diff <= tol + tol * w.abs()).all()) and ulps <= FLASH_BF16_ULPS,
                    f"backward {name}: max |d| {float(diff.max())}, {ulps} bf16 ulps")
            out[name] = dict(max_abs_err=float(diff.max()), max_abs_plain=ref,
                             max_bf16_ulps_of_scale=ulps)
    return out


def lm_train_bwd_rows(launches: dict) -> list:
    """The backward kernel at each of ``BWD_ROWS``' shapes, on seeded inputs:
    the forward's out with the log-sum-exp output on, bit for bit the forward
    without it; dq, dk, dv against the plain ``_flash_bwd`` on the card within
    the bounds; timed against its bound (2.5x the forward's operations over the
    keys each query sees, or the bytes), the plain version and SDPA's backward
    (fwd+bwd less fwd, the backend it picks); ``launches``: the training runs'
    backward launches at the row's shape."""
    rows = []
    for name, arch, b, sq, sk, causal, window, dtype in BWD_ROWS:
        t0 = time.perf_counter()
        cfg = get_model(arch).cfg
        h, kv = cfg.n_heads, cfg.n_kv_heads
        hd, hdv = cfg.hd + (cfg.rope_head_dim if cfg.use_mla else 0), cfg.vhd
        gen = torch.Generator(DEVICE).manual_seed(hd + hdv + h + sq)
        q, k, v, do = (torch.randn(dims, generator=gen, device=DEVICE).to(dtype)
                       for dims in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv),
                                    (b, sq, h, hdv)))
        out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
        require(torch.equal(out, flash_attention(q, k, v, causal=causal, window=window)),
                f"{name}: the log-sum-exp output changed the forward's out")
        bwd = lambda: flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
        grads = bwd()
        bq = min(512, sq)
        plain_fn = lambda: _flash_bwd(causal, window, bq, plain_block_k(sk),
                                      (q, k, v, out, lse), do)
        want = plain_fn()
        plain_dq = want[0]
        errs = _bwd_errors(grads, want, dtype)
        del want
        require(all(torch.equal(a, c) for a, c in zip(grads, bwd())),
                f"{name}: the backward's bits differ launch to launch")
        del grads
        ms = device_ms([bwd] * 5)
        plain = device_ms([plain_fn] * 2)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)
        mask = _window_mask(sq, sk, window) if window else None
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window, enable_gqa=h != kv)
        sdpa_fb = lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
        try:     # the yardstick only: no path of the port calls it
            lib_dq = sdpa_fb()[0].transpose(1, 2)
            lib = device_ms([sdpa_fb] * 3) - device_ms([sdpa] * 3)
            lib_diff = float((lib_dq.float() - plain_dq.float()).abs().max())
            lib_note = None
        except RuntimeError as e:   # no SDPA backend takes this backward
            lib, lib_diff, lib_note = None, None, str(e)[:200]
        ops = 2.5 * attention_ops(b, sq, sk, h, (hd + hdv) / 2, causal, window)
        # q, k, v, out, dout and lse read; dq, dk, dv written
        nbytes = (q.element_size() * (2 * (q.numel() + k.numel() + v.numel()) + out.numel()
                                      + do.numel()) + 4 * lse.numel())
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        bd, by = bound(nbytes, ops, peak)
        # bf16 rows: the training runs' backward launches at the row's shape; the
        # float32 row: the float32 card step's (B = 1, S = 256; no float32 run
        # trains at the row's shape)
        n = launches.get((b, sq, sk, causal, window, dtype), 0)
        at = (b, sq, sk)
        if dtype == torch.float32:
            n, at = launches.get("f32", 0), (TRAIN_F32_B, TRAIN_F32_S, TRAIN_F32_S)
        require(n > 0, f"{name}: no training run launched the backward at {at}")
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/kernels/flash_attention/csrc/"
                         "flash_attention_bwd.cu",
                         replaces="none: no Pallas counterpart (the backward of the custom VJP "
                         "of src/repro/models/flash.py:52, _flash_bwd at :114)",
                         launches=n, max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                         ms=ms, plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib,
                         library="scaled_dot_product_attention fwd+bwd less fwd",
                         library_max_abs_dq_diff=lib_diff, library_note=lib_note, errors=errs,
                         shape=dict(arch=arch, b=b, sq=sq, sk=sk, h=h, kv=kv, hd=hd, hdv=hdv,
                                    causal=causal, window=window, dtype=str(dtype)),
                         kernel_head_dim=padded_head_dim(hd, hdv), launches_at_shape=at,
                         tflop_per_s=ops / ms / 1e9, seconds=time.perf_counter() - t0))
        del q, k, v, do, out, lse, qt, kt, vt, dot, mask, plain_dq
        torch.cuda.empty_cache()
    return rows


def _train_step_parity() -> dict:
    """One float32 step of tinyllama at 2 of 22 layers, full width, on the card
    against the port on the CPU from the same weights and tokens: loss,
    grad_norm and every gradient leaf within the bounds."""
    from repro_torch.train.optimizer import clip_by_global_norm, get_optimizer
    from repro_torch.train.trainer import (TrainConfig, make_train_state, make_train_step,
                                           tree_leaves)
    over = {"n_layers": TRAIN_F32_LAYERS, "dtype": "float32"}
    batch = next(lm_batches(get_model(TRAIN_ARCH).cfg.vocab, TRAIN_F32_B, TRAIN_F32_S, seed=1))
    params = get_model(TRAIN_ARCH, overrides=over, device="cpu").init(0)
    got = {}
    for device in ("cpu", DEVICE):
        api = get_model(TRAIN_ARCH, overrides=over, device=device)
        p = _tree_to(params, device)
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        reset_launch_counts()
        loss = api.loss(p, tb)
        grads = torch.autograd.grad(loss, leaves)
        _, gnorm = clip_by_global_norm(list(grads), 1.0)
        counts = launch_counts()
        got[device] = (float(loss.detach()), float(gnorm), [g.cpu() for g in grads], counts)
        if device == DEVICE:
            require(counts["flash_attention"] == 2 * TRAIN_F32_LAYERS
                    and counts["flash_attention_bwd"] == TRAIN_F32_LAYERS,
                    f"float32 step launches {counts}")
            state = make_train_state(p, get_optimizer("adamw"), ("blocks",))
            step = make_train_step(api.loss, TrainConfig(optimizer="adamw", peak_lr=TRAIN_LR))
            _, m = step(state, tb)
            require(abs(m["loss"] - got[device][0]) <= 1e-6 * abs(got[device][0])
                    and m["skipped"] == 0.0,
                    f"the step's loss {m['loss']} against {got[device][0]}")
            f32_launches = flash_attention_bwd.routes["f32_cuda_cores"]
        del p, leaves, grads
    (lc, gc_, grads_c, _), (lg, gg, grads_g, _) = got["cpu"], got[DEVICE]
    leaf_rel = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                   for a, c in zip(grads_g, grads_c))
    require(abs(lg - lc) <= TRAIN_F32_LOSS_RTOL * abs(lc), f"float32 loss {lg} against {lc}")
    require(abs(gg - gc_) <= TRAIN_F32_GNORM_RTOL * gc_, f"float32 grad_norm {gg} against {gc_}")
    require(leaf_rel <= TRAIN_F32_GRAD_REL, f"float32 gradients: a leaf off by {leaf_rel}")
    return dict(loss_card=lg, loss_cpu=lc, grad_norm_card=gg, grad_norm_cpu=gc_,
                max_leaf_rel_err=leaf_rel, leaves=len(grads_c), f32_bwd_launches=f32_launches)


def _train_resume() -> dict:
    """bf16, tinyllama at 2 layers, full width: 6 steps straight against 3, a
    Checkpointer save, a restore into a fresh state, then 3 more."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import TrainConfig, make_train_state, make_train_step
    from repro_torch.train.tree import leaves_with_paths, tree_leaves
    over = {"n_layers": TRAIN_F32_LAYERS}
    api = get_model(TRAIN_ARCH, overrides=over)
    tc = TrainConfig(optimizer="adamw", peak_lr=TRAIN_LR, total_steps=RESUME_STEPS, warmup=2)
    stream = lm_batches(api.cfg.vocab, TRAIN_F32_B, TRAIN_F32_S, seed=2)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in next(stream).items()}
               for _ in range(RESUME_STEPS)]
    fresh = lambda seed: make_train_state(api.init(seed), get_optimizer("adamw"), ("blocks",))
    straight, step = fresh(0), make_train_step(api.loss, tc)
    for b in batches:
        straight, _ = step(straight, b)
    half = fresh(0)
    for b in batches[:RESUME_STEPS // 2]:
        half, _ = step(half, b)
    # bf16 params and adamw's float32 m and v: 10 bytes a parameter, twice over
    need = 2 * 10 * sum(t.numel() for t in tree_leaves(half.params))
    tmp = tempfile.mkdtemp(prefix="lm_resume_")
    try:
        free = shutil.disk_usage(tmp).free
        require(free >= need, f"resume: {free} bytes free under {tmp}, need {need}")
        t0 = time.perf_counter()
        path = Checkpointer(tmp).save(half)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        del half
        t0 = time.perf_counter()
        resumed, meta = Checkpointer(tmp).restore(fresh(5))
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step2 = make_train_step(api.loss, tc)
    for b in batches[RESUME_STEPS // 2:]:
        resumed, _ = step2(resumed, b)
    names = ([f"params/{n}" for n, _ in leaves_with_paths(straight.params)]
             + [f"opt_state/{n}" for n, _ in leaves_with_paths(straight.opt_state)])
    differ = {}
    for n, a, c in zip(names, tree_leaves(resumed.params) + tree_leaves(resumed.opt_state),
                       tree_leaves(straight.params) + tree_leaves(straight.opt_state)):
        if not torch.equal(a.detach(), c.detach()):
            differ[n] = float((a.float() - c.float()).norm() / c.float().norm().clamp_min(1e-30))
    require(all(r <= RESUME_REL for r in differ.values()),
            f"resume: leaves differ from the straight run {differ}")
    return dict(step=meta["step"], bits_equal=not differ, differing_leaves=differ,
                checkpoint_bytes=size, save_s=save_s, restore_s=restore_s,
                disk_free_bytes=free)


class recorded_drops:
    """Within the block, each MoE layer's dropped share (``moe_apply``'s aux)."""

    def __enter__(self) -> list:
        self.calls, self.apply = [], model_common.moe_apply

        def record(p, x, cfg, capacity=None):
            y, aux = self.apply(p, x, cfg, capacity)
            self.calls.append(float(aux["dropped"]))
            return y, aux

        model_common.moe_apply = record
        return self.calls

    def __exit__(self, *exc):
        model_common.moe_apply = self.apply


def _train_family(arch: str, over: dict, b: int, s: int, frames: int, steps: int) -> dict:
    """``steps`` bf16 training steps at full width and a cut depth, with the
    config's optimizer: finite losses, no skip; step ms, peak memory."""
    from repro_torch.launch.train import lm_state
    from repro_torch.train.trainer import make_train_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api, tc, state = lm_state(_train_args(arch, b, s, steps, overrides=over))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = api.cfg
    stream = lm_batches(cfg.vocab, b, s, seed=1)
    rng = np.random.default_rng(3)
    step = make_train_step(api.loss, tc)
    losses, ms, drops = [], [], []
    reset_launch_counts()
    with bwd_shapes() as shapes, recorded_drops() as dropped:
        for _ in range(steps):
            batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(stream).items()}
            if frames:
                batch["frames"] = torch.from_numpy(
                    rng.normal(size=(b, frames, cfg.d_model)).astype(np.float32)).to(DEVICE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(m["loss"])
            require(m["skipped"] == 0.0 and np.isfinite(m["loss"]),
                    f"{arch}: step skipped or loss {m['loss']}")
        drops = list(dropped)
    counts = launch_counts()
    if cfg.family != "ssm":
        require(counts["flash_attention_bwd"] > 0, f"{arch}: no backward kernel launch")
    fields = dict(arch=arch, reduced=over, batch=b, seq=s, frames=frames or None,
                  optimizer=cfg.optimizer, steps=steps, losses=losses, step_ms=ms,
                  init_s=init_s, max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches=counts, bwd_launches_by_shape=[
                      dict(b=k[0], sq=k[1], sk=k[2], causal=k[3], window=k[4], dtype=str(k[5]),
                           launches=n)
                      for k, n in shapes.launches.items()])
    if cfg.n_experts:
        fields["moe_dropped_share"] = drops
        fields["capacity"] = max(1, int(b * s * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    emit("lm_train_family", **fields)
    del api, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, shapes=shapes.launches)


def _train_lasso() -> dict:
    """launch.train.train_lasso at DATASETS["rcv1"], epsilon 1, T = LASSO_T, on
    the matrix its own generator call makes (made once here and handed to it);
    its coordinates against a torch_sparse solve of that matrix with the
    launcher's config (the generator's arguments differ from the solver
    phases': nnz/row 73.2, not 74; 512 informative features, not 64; and
    delta = 1/N^2, not 1e-6)."""
    from repro_torch.configs.paper_lasso import DATASETS
    from repro_torch.launch import train
    args = _train_args("paper-lasso", 0, 0, LASSO_T)
    ds = DATASETS["rcv1"]
    t0 = time.perf_counter()
    X, y = train.lasso_problem(ds, args.seed)
    gen_s = time.perf_counter() - t0
    lines = []
    t0 = time.perf_counter()
    got = train.train_lasso(args, log=lines.append, problem=(X, y))
    wall = time.perf_counter() - t0
    reset_launch_counts()
    res = solve(host_to_padded(X, device=DEVICE), y, train.lasso_config(args, ds))
    require(got["coords"] == res.coords.cpu().tolist(),
            "train_lasso's coordinates differ from torch_sparse's on its matrix")
    require(launch_counts()["coord_update"] == LASSO_T, "the solve ran no coord_update kernel")
    return dict(lines=lines, accuracy=got["accuracy"], nnz=got["nnz"], gap=got["gap"],
                solve_s=got["wall_s"], wall_s=wall, generate_s=gen_s, coords_equal=True)


def phase_lm_train() -> tuple:
    """Training on the card: the backward kernel's rows, tinyllama-1.1b's 30
    full-width steps through ``launch.train.train_lm`` (the main path, counts
    reset just before), its profiled steps, the float32 step against the CPU,
    the resume, the other families, ``train_lasso``."""
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = _train_args(TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS)
    lines = []
    reset_launch_counts()
    with bwd_shapes() as shapes:
        t0 = time.perf_counter()
        run = train.train_lm(args, log=lines.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    routes, bwd_routes = dict(flash_attention.routes), dict(flash_attention_bwd.routes)
    peak = torch.cuda.max_memory_allocated()
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    require(len(hist) == TRAIN_STEPS and all(np.isfinite(losses))
            and not any(h["skipped"] for h in hist), f"tinyllama: losses {losses}")
    fall = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    require(fall >= TRAIN_LOSS_FALL, f"tinyllama: the loss fell {fall} nats, not "
            f">= {TRAIN_LOSS_FALL}")
    n_layers = get_model(TRAIN_ARCH).cfg.n_layers
    # remat: a layer's forward runs twice a step, its backward once
    require(counts["flash_attention"] == 2 * n_layers * TRAIN_STEPS
            and counts["flash_attention_bwd"] == n_layers * TRAIN_STEPS
            and routes["bf16_tensor_cores"] == counts["flash_attention"]
            and bwd_routes["bf16_tensor_cores"] == counts["flash_attention_bwd"],
            f"tinyllama training launches {counts}, routes {routes}, {bwd_routes}")
    step_ms = [h["sec"] * 1e3 for h in hist]
    med = float(np.median(step_ms[4:]))
    # the busy share of TRAIN_PROFILED steps (batches on the card before the window)
    state, step_fn = run["state"], run["step_fn"]
    stream = lm_batches(get_model(TRAIN_ARCH).cfg.vocab, TRAIN_B, TRAIN_S, seed=7)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in next(stream).items()}
               for _ in range(TRAIN_PROFILED)]

    def window():
        nonlocal state
        for b in batches:
            state, _ = step_fn(state, b)

    prof = profile_steps("lm_train", TRAIN_PROFILED, window, quiet=True, device_only=True)
    busy = sum(prof["by_kernel"].values())
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    del state, step_fn, run, batches
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_train", arch=TRAIN_ARCH, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
         lr=TRAIN_LR, losses=losses, loss_fall_first5_last5=fall,
         step_ms=step_ms, step_ms_median_5_30=med,
         tokens_per_s=TRAIN_B * TRAIN_S / (med / 1e3), wall_s=wall,
         tokens_per_s_wall=TRAIN_STEPS * TRAIN_B * TRAIN_S / wall,
         max_memory_allocated=peak, launches_per_step={k: v / TRAIN_STEPS for k, v in
                                                       counts.items() if v},
         profiled_steps=TRAIN_PROFILED, wall_ms_profiled=prof["wall_ms"],
         device_busy_ms_per_step=busy / TRAIN_PROFILED,
         device_idle_share=1.0 - busy / prof["wall_ms"],
         top_device=[{"name": k[:80], "ms": v / TRAIN_PROFILED} for k, v in top],
         log_tail=lines[-3:])
    t1 = time.perf_counter()
    parity = _train_step_parity()
    emit("lm_train_f32_parity", seconds=time.perf_counter() - t1, **parity)
    t1 = time.perf_counter()
    resume = _train_resume()
    emit("lm_train_resume", seconds=time.perf_counter() - t1, **resume)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(shapes.launches)
    launches["f32"] = parity["f32_bwd_launches"]
    family_counts = {}
    for arch, (over, b, s, frames, steps) in TRAIN_FAMILIES.items():
        got = _train_family(arch, over, b, s, frames, steps)
        family_counts[arch] = got["counts"]
        for key, n in got["shapes"].items():
            launches[key] = launches.get(key, 0) + n
    t1 = time.perf_counter()
    lasso = _train_lasso()
    emit("lm_train_lasso", seconds=time.perf_counter() - t1, **lasso)
    t1 = time.perf_counter()
    rows = lm_train_bwd_rows(launches)
    emit("lm_train_bwd_rows", seconds=time.perf_counter() - t1)
    emit("lm_train_phase", seconds=time.perf_counter() - t_phase)
    return rows, dict(counts=counts, per_step=TRAIN_STEPS), family_counts


def add_path_launches(kernels: list, paths: dict) -> None:
    """The launches of the later slices' paths beside each kernel's
    main-path count, a path's rebuild-only draws included: ``torch_dense``,
    the oracle, the fit service's run, ``jax_shard`` at 1×1 and each
    ``lm_archs`` arch's bf16 forward."""
    for entry in kernels:
        name = entry["name"]
        entry["launches_by_path"] = {
            path: run["counts"].get(name, 0) + run["rebuilds"].get(name, 0)
            for path, run in paths.items()}


def add_repacked(kernels: list, repacked: dict) -> None:
    """Each of rows 1-4 gets its times on the round-1 survivor pair, under
    ``repacked_*`` keys marked by the survivors' D."""
    for entry in kernels:
        for key, val in repacked.get(entry["name"], {}).items():
            entry[f"repacked_{key}"] = val


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    X, csc, y, pcsr, pcsc, col_nnz, pad_s = phase_data()
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
    dense, cpu_pair = phase_parity(X, y, pcsr, pcsc, col_nnz)
    screen, screen_windows = phase_screen(X, y, y_t, pcsr, pcsc, cpu_pair)
    del cpu_pair
    dup = phase_duplicates(X, csc, y, y_t, buckets)
    phase_gap_tol(pcsr, pcsc, y, runs, alg1)
    phase_path(pcsr, pcsc, y)
    sweep = phase_sweep(pcsr, pcsc, y)
    kernels = phase_kernel_times(X, csc, y_t, pcsr, pcsc, runs, alg1, buckets, errs, share,
                                 window)
    add_repacked(kernels, repacked_kernel_times(y_t, screen))
    kernels.extend(lane_kernel_times(X, csc, y_t, pcsr, pcsc, runs, sweep, buckets))
    del sweep, screen
    phase_autotune(pcsr, pcsc, y)
    phase_auto_backend(pcsr, pcsc, y)
    phase_store(X, y, y_t, pcsr, pcsc, runs, dense, pad_s, dup)
    refs = {name: dict(res=run["res"]) for name, run in runs.items()}
    del csc, pcsr, pcsc, runs, alg1, dense, dup
    torch.cuda.empty_cache()
    flash_errs = phase_flash_vs_plain()
    api, params, api32, p32, routes, f32_routes = phase_lm_forward()
    phase_lm_serve(api, params, api32, p32)
    del p32
    phase_lm_probe(api, params)
    del api, params
    screen_busy(screen_windows)
    del screen_windows
    # the other engines and the fit service, last: on a pair padded anew, after
    # every profiled window of the older phases (two runs with these phases
    # before the sweep dropped a lane window's first step from its profile)
    torch.cuda.empty_cache()
    pcsr, pcsc = host_to_padded(X, device=DEVICE)
    cpu_pair = host_to_padded(X, device="cpu")
    engines = phase_engines(pcsr, pcsc, y, y_t, refs, cpu_pair)
    reference = phase_reference(pcsr, pcsc, y_t, refs, cpu_pair)
    del cpu_pair
    phase_host_sparse(X, y, pcsr, pcsc, y_t, refs)
    service = phase_fit_service(pcsr, pcsc, y, refs)
    engines_busy(pcsr, pcsc, y_t)
    # this slice's phases, last: the in-order scatter, the sharded engine, flash's head dims
    shard = phase_shard_1x1(X, y, refs, lambda k, picks: _tie_margin(pcsr, pcsc, y_t, False,
                                                                     k, picks))
    del pcsr, pcsc
    torch.cuda.empty_cache()
    phase_scatter_vs_plain(X)
    phase_flash_head_dims()
    phase_shard_2x2_gloo()
    del X
    # the other decoder archs, alone on the card
    archs = phase_lm_archs()
    kernels.extend(flash_kernel_times(routes, f32_routes, flash_errs))
    kernels.append(shard["row"])
    kernels.extend(arch_flash_rows(archs))
    # training, last: tinyllama-1.1b's steps (this slice's main path), the other families
    bwd_rows, train_run, family_counts = phase_lm_train()
    kernels.extend(bwd_rows)
    for entry in kernels:
        if entry["name"] == "flash_attention":
            entry["launches_per_train_step"] = (train_run["counts"]["flash_attention"]
                                                / train_run["per_step"])
    add_path_launches(kernels, {
        **{f"torch_dense_{r}": engines[r] for r in engines},
        **{f"reference_{r}": reference[r] for r in reference},
        "fit_service": service,
        **{f"jax_shard_{r}": dict(counts=c, rebuilds={}) for r, c in shard["counts"].items()},
        **{f"lm_{arch}": dict(counts=run["counts"], rebuilds={}) for arch, run in archs.items()},
        f"lm_train_{TRAIN_ARCH}": dict(counts=train_run["counts"], rebuilds={}),
        **{f"lm_train_{arch}": dict(counts=c, rebuilds={}) for arch, c in family_counts.items()}})
    emit("done", seconds=time.perf_counter() - t_start)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
