"""One rank of ``tests/test_torch_shard_dist.py``'s 2×2 gloo run (CPU).

Imported by the spawned ranks, so it imports neither JAX nor the JAX
package.  ``run(rank, world, data)`` drives every 2×2 case on this rank and
returns host arrays; the test checks that the four ranks return the same
bits and compares rank 0's with the JAX package's 2×2 run.
"""
import os

import numpy as np

LAM, STEPS, GAP_TOL, TOPK = 8.0, 60, 3e-3, 8


def _host(t):
    return t.detach().cpu().numpy()


def _result(res):
    return {"w": _host(res.w), "gaps": _host(res.gaps), "coords": _host(res.coords),
            "stop_step": int(res.stop_step)}


def run(rank, world, data):
    from repro_torch import FWConfig, grid, solve, solve_many
    from repro_torch.core.dp.accountant import PrivacyAccountant
    from repro_torch.core.solvers.config import check_supported
    from repro_torch.core.solvers.planner import choose_backend, data_stats
    from repro_torch.core.sparse.formats import HostCSR
    from repro_torch.data.store import DatasetStore
    from repro_torch.distributed import DistFWConfig, build_block_sparse, distributed_fw
    from repro_torch.distributed.collectives import make_mesh
    from repro_torch.serve import FitRequest, FitService, FitServiceConfig

    X = HostCSR(data["indptr"], data["indices"], data["data"], data["shape"])
    y = data["y"]
    mesh = make_mesh(2, 2)
    assert (mesh.a, mesh.b, mesh.rank) == (2, 2, rank) and mesh.distributed
    blocks = build_block_sparse(X, 2, 2)
    y_pad = np.zeros(blocks.padded[0], np.float32)
    y_pad[:len(y)] = y
    out = {}
    for name, cfg in (
            ("argmax", DistFWConfig(lam=LAM, steps=STEPS, selection="argmax")),
            ("gumbel", DistFWConfig(lam=LAM, steps=STEPS, selection="gumbel", epsilon=1.0)),
            ("topk", DistFWConfig(lam=LAM, steps=STEPS, selection="argmax", compress_topk=TOPK)),
            ("gap_tol", DistFWConfig(lam=LAM, steps=STEPS, selection="argmax", gap_tol=GAP_TOL))):
        w, gaps, coords, stop = distributed_fw(blocks, y_pad, cfg, mesh, device="cpu")
        out[name] = {"w": _host(w), "gaps": _host(gaps), "coords": _host(coords),
                     "stop_step": int(stop)}

    base = FWConfig(backend="jax_shard", mesh=(2, 2), lam=LAM, steps=STEPS, device="cpu")
    check_supported(base)
    out["auto_backend"] = choose_backend(data_stats(X), FWConfig(backend="auto", mesh=(2, 2),
                                                                 device="cpu"))
    out["registry"] = _result(solve(X, y, base))

    sweep = grid(FWConfig(backend="jax_shard", mesh=(2, 2), steps=25, queue="bsls",
                          device="cpu"), lam=(4.0, 8.0))
    out["sweep"] = [_result(r) for r in solve_many(X, y, sweep)]
    out["sweep_own"] = [_result(solve(X, y, c)) for c in sweep]

    store = DatasetStore.open(data["store"])
    out["store"] = _result(solve(store, config=FWConfig(backend="jax_shard", mesh=(2, 2),
                                                        lam=LAM, steps=30, device="cpu")))
    out["store_memory"] = _result(solve(X, y, FWConfig(backend="jax_shard", mesh=(2, 2),
                                                       lam=LAM, steps=30, device="cpu")))
    out["blocks_cache"] = os.path.exists(os.path.join(data["store"], "cache",
                                                      "blocks-2x2-meta.json"))

    svc = FitService(X, y, {"acme": PrivacyAccountant(epsilon=4.0, delta=1e-6,
                                                      total_steps=4000)},
                     FitServiceConfig(device="cpu"))
    private = FWConfig(backend="jax_shard", mesh=(2, 2), lam=LAM, steps=20, queue="bsls",
                       epsilon=1.0, delta=1e-6, device="cpu")
    exact = FWConfig(backend="jax_shard", mesh=(2, 2), lam=LAM, steps=20, device="cpu")
    svc.submit(FitRequest(0, "acme", private))
    svc.submit(FitRequest(1, "acme", exact))
    done = {r.uid: r for r in svc.run()}
    out["service_status"] = [done[0].status, done[1].status]
    out["service"] = [_result(done[i].result) for i in (0, 1)]
    out["service_own"] = [_result(solve(X, y, c)) for c in (private, exact)]
    out["service_charged"] = svc.accountants["acme"].spent_steps
    out["service_expected_charge"] = svc._charged_steps(svc.accountants["acme"],
                                                        done[0].config)
    return out


def record_collectives(rank, world, data):
    """The collectives this rank of a real 2×2 grid sends (``ShardMesh``'s
    recorder) in one private run of ``data["steps"]`` steps on its block:
    ``tests/test_torch_launch_dryrun.py`` holds rank 0's against ``DryMesh``."""
    import dataclasses

    import torch

    from repro_torch import prng
    from repro_torch.distributed.block_sparse import BlockAssembler
    from repro_torch.distributed.collectives import make_mesh
    from repro_torch.distributed.fw_shard import (DistFWConfig, rank_labels, shard_scan,
                                                  shard_setup)

    n, d = data["shape"]
    rec = []
    mesh = dataclasses.replace(make_mesh(2, 2), recorder=rec)
    asm = BlockAssembler(n, d, 2, 2)
    asm.count(data["rows"], data["cols"])
    asm.alloc(data["kc"], data["kr"])
    asm.fill(data["rows"], data["cols"], data["vals"])
    blocks = asm.finish()
    blk = blocks.local(mesh.ai, mesh.bj, "cpu")
    y_pad = torch.zeros(blocks.padded[0], dtype=torch.float32)
    y_pad[:n] = torch.as_tensor(data["y"], dtype=torch.float32)
    y_loc = rank_labels(y_pad, blocks, mesh)
    cfg = DistFWConfig(steps=data["steps"])
    setup = shard_setup(blk, y_loc, n=n, loss=cfg.loss, mesh=mesh)
    shard_scan(blk, y_loc, setup, lams=[cfg.lam], em_scales=[cfg.em_scale(n)], gap_tols=[0.0],
               keys=[prng.PRNGKey(0)], steps=cfg.steps, shape=(n, d), mesh=mesh)
    return {"padding": (asm.kc, asm.kr), "records": [tuple(c) for c in rec]}
