"""Dry run of the production meshes (port of ``repro.launch.dryrun``).

For every (architecture × input shape) cell, lay the step's arguments out
on the production mesh (16×16, or 2×16×16 with ``--multi-pod``) with the
rules of ``launch/sharding.py``, and report what each device would hold
and do, for a grid that has not been rented:

* the layout of every leaf, and every dim that fell back to replication
  (``fallbacks``, the JAX package's lines letter for letter);
* the bytes each device holds of the step's arguments
  (``memory.argument_size_in_bytes``, from the specs);
* the FLOPs of one step (``flops``): ``roofline/counts.py`` ``step_flops``,
  ``FlopCounterMode`` over the port's step on ``meta`` at full size.

The JAX package compiles each cell for 512 fake host devices and reads
these from XLA.  The port has no SPMD compiler and runs no tensor-parallel
LM, so an LM cell is counted on the host, on ``meta`` (``trace_s`` takes
the place of ``compile_s``), ``bytes_accessed`` is ``null`` (nothing counts
a kernel's traffic without a compiler) and so are the collective bytes.

``--arch paper-lasso`` runs the sharded engine's program for each Table-2
dataset (``configs/paper_lasso.py``) on the card: rank 0 of the mesh's
(a × b) grid (a = pod·data row shards, b = model feature shards) steps
alone on ``DryMesh`` for 50 steps (``core/solvers/jax_shard.py``
``shard_dry_run``), at the padding (Kc, Kr) the JAX dry run gives it.  Its
cell adds the collectives it sent, by kind (``collective_bytes`` over the
run, ``collective_bytes_flat`` over the setup and one step), the counts a
step, the in-order scatter's launches, and ``memory.peak_bytes``
(``torch.cuda.max_memory_allocated`` over the cell, which counts what was
allocated before it, ``memory.allocated_before_bytes``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper-lasso --both-meshes  # a card
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import batch_axes, make_production_mesh, shard_grid
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import (cache_len, cache_tree, get_model, input_specs,
                                         params_tree, stacked_names, state_tree,
                                         supported_cells)
from repro_torch.roofline.analysis import two_point_total
from repro_torch.roofline.counts import (collective_bytes, collective_bytes_flat,
                                         collectives_per_step, step_flops)
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_state

# per-arch microbatch (gradient accumulation) for the train_4k cell; 1 = no
# accumulation
TRAIN_MICROBATCH = {
    "kimi-k2-1t-a32b": 8,
    "deepseek-v2-236b": 4,
    "chameleon-34b": 2,
    "nemotron-4-15b": 2,
}

# the optimized configuration (--optimized): FSDP grades and microbatches
PERF_OVERRIDES = {
    "kimi-k2-1t-a32b": dict(fsdp="zero3_moe", microbatches=64, moe_groups=16,
                            moe_combine="scatter"),
    "deepseek-v2-236b": dict(fsdp="zero3_moe", microbatches=32, moe_groups=16,
                             moe_combine="scatter"),
    "chameleon-34b": dict(fsdp="zero2", microbatches=16),
    "nemotron-4-15b": dict(dp="full", microbatches=1, grad_dtype="bfloat16"),
    "falcon-mamba-7b": dict(microbatches=16),
    "recurrentgemma-2b": dict(microbatches=16),
    "minicpm-2b": dict(fsdp="zero2", microbatches=4),
    "tinyllama-1.1b": dict(microbatches=2),
    "llama3.2-1b": dict(microbatches=2),
    "seamless-m4t-medium": dict(),
}
OPTIMIZED = False  # set by main(); the build_* functions read it

LASSO_STEPS = 50


def _perf(arch: str) -> dict:
    return PERF_OVERRIDES.get(arch, {}) if OPTIMIZED else {}


def _perf_overrides(arch: str, overrides=None) -> dict:
    """The model-level knobs of ``_perf`` merged into ``overrides``."""
    perf = _perf(arch)
    out = dict(overrides or {})
    if perf.get("moe_groups"):
        out["moe_local_groups"] = perf["moe_groups"]
    if perf.get("moe_combine"):
        out["moe_combine"] = perf["moe_combine"]
    return out


def _logits_spec(shape, mesh, log) -> None:
    shd._sanitize((batch_axes(mesh), None, "model"), shape, mesh, log, "logits")


def build_train(arch: str, mesh, log, overrides=None):
    """([(tree, specs)] of the step's arguments, a FLOP count thunk)."""
    perf = _perf(arch)
    mb = perf.get("microbatches", TRAIN_MICROBATCH.get(arch, 1))
    full_dp = perf.get("dp") == "full"
    overrides = _perf_overrides(arch, overrides)
    if perf.get("unroll"):
        overrides["unroll_layers"] = True
    api = get_model(arch, overrides=overrides or None, device="meta")
    cfg = api.cfg
    params = api.init()
    state = make_train_state(params, get_optimizer(cfg.optimizer), stacked_names(cfg))
    state_t = state_tree(state, cfg)
    state_s = shd.params_shardings(state_t, mesh, log,
                                   fsdp=True if full_dp else perf.get("fsdp", False))
    batch = input_specs(arch, "train_4k", overrides=overrides or None)
    batch_s = shd.batch_shardings(batch, mesh, log,
                                  axes=("pod", "data", "model") if full_dp else None)
    flops = lambda: step_flops(api, "train", params, batch, microbatches=mb)
    return [(state_t, state_s), (batch, batch_s)], flops


def build_prefill(arch: str, mesh, log, overrides=None):
    overrides = _perf_overrides(arch, overrides)
    api = get_model(arch, overrides=overrides or None, device="meta")
    params = api.init()
    params_t = params_tree(params, api.cfg)
    params_s = shd.params_shardings(params_t, mesh, log, fsdp=_perf(arch).get("fsdp", False))
    batch = input_specs(arch, "prefill_32k", overrides=overrides or None)
    batch_s = shd.batch_shardings(batch, mesh, log)
    _logits_spec((SHAPES["prefill_32k"].global_batch, 1, api.cfg.padded_vocab), mesh, log)
    flops = lambda: step_flops(api, "prefill", params, batch)
    return [(params_t, params_s), (batch, batch_s)], flops


def build_decode(arch: str, shape_name: str, mesh, log, overrides=None):
    overrides = _perf_overrides(arch, overrides)
    api = get_model(arch, overrides=overrides or None, device="meta")
    params = api.init()
    params_t = params_tree(params, api.cfg)
    params_s = shd.params_shardings(params_t, mesh, log, fsdp=_perf(arch).get("fsdp", False))
    cache = api.init_cache(*cache_len(api.cfg, shape_name))
    cache_t = cache_tree(cache, api.cfg)
    cache_s = shd.cache_shardings(cache_t, mesh, log)
    inputs = input_specs(arch, shape_name, overrides=overrides or None)
    tokens = {"": inputs["tokens"]}                 # the bare leaf, as JAX shards it
    tokens_s = shd.batch_shardings(tokens, mesh, log)
    # the SSM's decode is position-free: it holds no position (nor does XLA
    # keep the unused argument)
    pos = {} if api.cfg.family == "ssm" else {"pos": inputs["pos"]}
    _logits_spec((inputs["tokens"].shape[0], 1, api.cfg.padded_vocab), mesh, log)
    flops = lambda: step_flops(api, "decode", params, inputs, cache=cache)
    return [(params_t, params_s), (cache_t, cache_s), (tokens, tokens_s),
            (pos, {p: shd.replicated(mesh) for p in pos})], flops


def lasso_padding(dataset: str, mesh) -> tuple:
    """(a, b, Kc, Kr) of the JAX dry run's ``build_lasso``: the dataset's
    average lanes a block column and row, ×4 (a skew allowance), at least 8."""
    from repro_torch.configs.paper_lasso import DATASETS
    ds = DATASETS[dataset]
    a, b = shard_grid(mesh)
    kc = max(8, int(ds.n * (ds.nnz_per_row / ds.d) / a * 4))     # rows a column a block
    kr = max(8, int(ds.nnz_per_row / b * 4))                       # columns a row a block
    return a, b, kc, kr


def build_lasso(dataset: str, mesh, *, steps: int = LASSO_STEPS, seed: int = 0,
                device="cuda") -> dict:
    """The paper's own workload: rank 0's part of the ``jax_shard`` program
    on a Table-2-sized design (``shard_dry_run``), on ``device``."""
    from repro_torch.configs.paper_lasso import DATASETS
    from repro_torch.core.solvers.jax_shard import shard_dry_run
    ds = DATASETS[dataset]
    a, b, kc, kr = lasso_padding(dataset, mesh)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    run = shard_dry_run(ds.n, ds.d, a, b, steps=steps, kc=kc, kr=kr,
                        density=ds.nnz_per_row / ds.d, seed=seed, device=device)
    peak, base = (torch.cuda.max_memory_allocated(), base) if on_card else (None, None)
    blk = run.block
    return {
        "flops": None,
        "collective_bytes": collective_bytes(run.records),
        "collective_bytes_flat": collective_bytes_flat(run),
        "collective_bytes_output": collective_bytes(run.output),
        "collectives_per_step": collectives_per_step(run),
        "bytes_per_step": sum(c.nbytes for c in run.step),
        "steps": steps,
        "grid": [a, b], "kc": kc, "kr": kr,
        "d_loc": int(blk.csc_rows.shape[0]), "n_loc": int(blk.csr_cols.shape[0]),
        "live_lanes": int((blk.csc_vals != 0).sum()),
        "scatter_launches": run.scatter_launches,
        "memory": {"argument_size_in_bytes": run.block_bytes, "peak_bytes": peak,
                   "allocated_before_bytes": base},
    }


def _layer_points(arch: str):
    """Two layer counts for the two-point FLOP check, and the full depth
    (the JAX package's points: two small depths that keep a pattern's mix)."""
    cfg = get_config(arch)
    u = {"unroll_layers": True}
    if cfg.family == "encdec":
        mk = lambda l: {"n_layers": 2 * l, "enc_layers": l, "dec_layers": l, **u}
        return (2, mk(2)), (4, mk(4)), cfg.n_layers
    if cfg.layer_pattern:
        n = len(cfg.layer_pattern)
        return ((n, {"n_layers": n, **u}), (2 * n, {"n_layers": 2 * n, **u}), cfg.n_layers)
    return (2, {"n_layers": 2, **u}), (4, {"n_layers": 4, **u}), cfg.n_layers


def _build(arch, shape_name, mesh, log, overrides=None):
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return build_train(arch, mesh, log, overrides)
    if kind == "prefill":
        return build_prefill(arch, mesh, log, overrides)
    return build_decode(arch, shape_name, mesh, log, overrides)


def run_cell(arch: str, shape_name: str, multi_pod: bool, two_point: bool = False, *,
             seed: int = 0, device="cuda") -> dict:
    log: list = []
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh.name}
    if arch == "paper-lasso":
        cell = build_lasso(shape_name, mesh, seed=seed, device=device)
        two_point_data = None
    else:
        args, flops = _build(arch, shape_name, mesh, log)
        cell = {"flops": flops(), "collective_bytes": None, "collective_bytes_flat": None,
                "memory": {"argument_size_in_bytes": sum(shd.device_bytes(t, s, mesh)
                                                         for t, s in args),
                           "peak_bytes": None}}
        two_point_data = None
        if two_point and not multi_pod:
            (l1, ov1), (l2, ov2), l_full = _layer_points(arch)
            pts = {}
            for tag, (layers, ov) in (("l1", (l1, ov1)), ("l2", (l2, ov2))):
                pts[tag] = {"layers": layers, "flops": _build(arch, shape_name, mesh, [],
                                                                overrides=ov)[1](),
                            "bytes": None}
            pts["l_full"] = l_full
            pts["flops_total"] = two_point_total(pts["l1"]["flops"], pts["l2"]["flops"],
                                                 l1, l2, l_full)
            two_point_data = pts
    result.update(trace_s=round(time.time() - t0, 3), bytes_accessed=None,
                  two_point=two_point_data, fallbacks=log, **cell)
    return result


def main(argv=None):
    global OPTIMIZED
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all supported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply PERF_OVERRIDES (FSDP grades, microbatches)")
    ap.add_argument("--two-point", action="store_true",
                    help="also count at two small depths and extrapolate (a check of "
                         "the full-depth count)")
    ap.add_argument("--seed", type=int, default=0, help="paper-lasso: the block's COO seed")
    ap.add_argument("--device", default="cuda", help="paper-lasso: where the program runs")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    OPTIMIZED = args.optimized

    archs = [args.arch] if args.arch else ARCH_IDS
    results, failures = [], []
    for arch in archs:
        if arch == "paper-lasso":
            from repro_torch.configs.paper_lasso import DATASETS
            shapes = [args.shape] if args.shape else list(DATASETS)
        else:
            shapes = [args.shape] if args.shape else supported_cells(arch)
        for shape_name in shapes:
            meshes = [False, True] if args.both_meshes else [args.multi_pod]
            for mp in meshes:
                tag = f"{arch} × {shape_name} × {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_cell(arch, shape_name, mp, two_point=args.two_point,
                                 seed=args.seed, device=args.device)
                    results.append(r)
                    arg_gb = r["memory"]["argument_size_in_bytes"] / 2**30
                    coll = r["collective_bytes"]
                    flops = "n/a" if r["flops"] is None else f"{r['flops']:.3e}"
                    print(f"[ok] {tag}: trace={r['trace_s']}s flops={flops} "
                          f"args/device={arg_gb:.3f}GiB fallbacks={len(r['fallbacks'])} "
                          f"coll={"n/a" if coll is None else f"{sum(coll.values())}B"}", flush=True)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append({"cell": tag, "error": str(e)})
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
            # incremental save so long sweeps are restartable
            with open(args.out, "w") as f:
                json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} cells ok, {len(failures)} failed → {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
