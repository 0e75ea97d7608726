"""Run the sharded engine (``jax_shard``) over a·b ranks on one host.

A ``jax_shard`` solve is SPMD: every rank of a default process group of a·b
ranks calls ``solve`` with the same config and data and gets the whole
result.  ``run_ranks(fn, world, ...)`` starts such a group: it spawns
``world`` processes, each joining a process group on
``tcp://127.0.0.1:<free port>`` (gloo or NCCL) with a timeout, calls
``fn(rank, world, *args)`` and returns the ranks' return values in rank
order; a rank that fails, or a group that outlives its deadline, fails the
call and every process is stopped.  ``solve_rank`` is such an ``fn``: the
synthetic problem from a seed, solved on a grid, with its timings.

NCCL takes one card per rank, so a host with one card runs a·b > 1 over
gloo (each rank's compute stays on the card; ``distributed.collectives``).
"""
from __future__ import annotations

import datetime
import socket
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, timeout_s, args, queue):
    try:
        torch.set_num_threads(1)                # the ranks share the host's cores
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # reported to the parent, then re-raised
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, backend: str = "gloo", timeout_s: float = 300.0,
              args: Sequence = ()) -> List:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one process
    group; their return values (picklable, host-side) in rank order."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, timeout_s, tuple(args), queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failures = {}, []
    deadline = time.monotonic() + timeout_s + 30.0
    try:
        while len(results) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks gave no result "
                                   f"within {timeout_s:.0f} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 5.0))
            except Exception:                   # queue.Empty: check for dead ranks
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and not failures:
                    failures.append(f"a rank exited with code {dead[0]} before reporting")
                    break
                continue
            if not ok:
                failures.append(f"rank {rank}:\n{value}")
                break
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10.0 if not failures else 1.0)
            if p.is_alive():
                p.terminate()
                p.join()
    if failures:
        raise RuntimeError("jax_shard ranks failed:\n" + "\n".join(failures))
    return [results[r] for r in range(world)]


def solve_rank(rank: int, world: int, opts: dict) -> dict:
    """One rank of a grid's solves: the synthetic problem from ``opts``'
    seed; its block layout, this rank's block on ``opts["device"]`` and the
    mesh built first (``prep_s``) and a 2-step solve to start the
    communicators and load the kernels; then ``solve`` under the group for
    each queue of ``opts["queues"]`` on that one ``ShardSource``.  Each
    result as host lists, with its wall seconds and its ``shard.setup`` and
    ``shard.scan`` spans."""
    from repro_torch import FWConfig, obs, solve
    from repro_torch.data.synthetic import make_sparse_classification
    from repro_torch.distributed.collectives import make_mesh
    from repro_torch.distributed.ingest import ShardSource
    if opts["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if opts["backend"] == "nccl" else 0)
    X, y, _ = make_sparse_classification(n=opts["n"], d=opts["d"], nnz_per_row=opts["nnz"],
                                         informative=opts["informative"], seed=opts["seed"])
    src = ShardSource.from_any(X)
    a, b = opts["mesh"]
    config = lambda queue, steps: FWConfig(backend="jax_shard", mesh=(a, b), lam=opts["lam"],
                                           steps=steps, queue=queue, device=opts["device"])
    t0 = time.perf_counter()
    mesh = make_mesh(a, b)
    src.local(a, b, mesh.ai, mesh.bj, opts["device"])
    prep_s = time.perf_counter() - t0
    solve(src, y, config(opts["queues"][0], 2))
    runs = {}
    for queue in opts["queues"]:
        with obs.session() as tel:
            t0 = time.perf_counter()
            res = solve(src, y, config(queue, opts["steps"]))
            wall = time.perf_counter() - t0
        spans = {e["name"]: e["dur_s"] for e in tel.events if e["ev"] == "span"}
        runs[queue] = {"wall_s": wall, "setup_s": spans["shard.setup"],
                       "scan_s": spans["shard.scan"], "coords": res.coords.tolist(),
                       "gaps": res.gaps.tolist(), "w": res.w.cpu().numpy().tolist()}
    return {"rank": rank, "world": world, "prep_s": prep_s, "runs": runs}
