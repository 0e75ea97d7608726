"""Training launcher — LM architectures and the paper's DP-LASSO runs (port of
``repro.launch.train``).

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 30 --batch 8 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lasso \\
      --dataset rcv1 --steps 500 --epsilon 1.0
On the CPU, at the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
      --device cpu --steps 20 --batch 4 --seq 64

``train_lm`` trains with random weights from ``--seed`` on the port's
Markov token stream (``data.synthetic.lm_batches``, seeded), through
``train.make_train_step`` and ``train.fit``, checkpointing to ``--ckpt-dir``
(``--resume`` restores the latest step).  ``train_lasso`` solves the
paper's DP-LASSO on a synthetic twin of ``--dataset`` with the
``torch_sparse`` backend (queue ``two_level`` when ε > 0, ``group_argmax``
otherwise) and prints its accuracy, nnz, last gap and privacy spend.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def lm_state(args):
    """(model API, TrainConfig, a fresh TrainState): the arch at ``--smoke``
    size or full, its config's optimizer, ``args.overrides`` (a dict of
    config fields, e.g. a cut depth) applied when given."""
    from repro_torch.interop import stacked_groups
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import TrainConfig, make_train_state

    api = get_model(args.arch, smoke=args.smoke, device=args.device,
                    overrides=getattr(args, "overrides", None))
    cfg = api.cfg
    tc = TrainConfig(optimizer=cfg.optimizer, peak_lr=args.lr,
                     total_steps=args.steps, warmup=max(args.steps // 20, 5),
                     microbatches=args.microbatches,
                     schedule="wsd" if args.arch == "minicpm-2b" else "cosine")
    state = make_train_state(api.init(args.seed), get_optimizer(tc.optimizer),
                             [name for name, n in stacked_groups(cfg).items() if n])
    return api, tc, state


def train_lm(args, log=print) -> dict:
    """Train ``args.steps`` steps; returns the run's summary with its
    ``history`` (a line every ``steps // 20`` steps), and the final
    ``state`` and ``step_fn`` (``main`` writes all but those two)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.train.trainer import fit, make_train_step
    from repro_torch.train.tree import tree_leaves

    api, tc, state = lm_state(args)
    cfg = api.cfg
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    log(f"[train] {args.arch}{' (smoke)' if args.smoke else ''}: "
        f"{n_params/1e6:.1f}M params, {args.steps} steps, "
        f"batch {args.batch}×{args.seq} on {api.device}")

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        log(f"[train] resumed from step {meta.get('step')}")

    frames = cfg.d_model if cfg.family == "encdec" else None
    stream = lm_batches(cfg.vocab, args.batch, args.seq, seed=args.seed, frames_dim=frames)
    loader = ShardedLoader(stream, device=api.device)
    step_fn = make_train_step(api.loss, tc)
    t0 = time.time()
    try:
        state, history = fit(state, step_fn, loader, steps=args.steps,
                             checkpointer=ckpt, ckpt_every=args.ckpt_every,
                             log_every=max(args.steps // 20, 1), log=log)
    finally:
        loader.close()
    wall = time.time() - t0
    first, last = history[0]["loss"], history[-1]["loss"]
    tok_s = args.steps * args.batch * args.seq / wall
    log(f"[train] done: loss {first:.3f} → {last:.3f} "
        f"({wall:.1f}s, {tok_s:.0f} tok/s)")
    return {"arch": args.arch, "loss_first": first, "loss_last": last,
            "wall_s": wall, "tokens_per_s": tok_s, "history": history,
            "state": state, "step_fn": step_fn}


def lasso_problem(ds, seed: int):
    """(X as HostCSR, y): the synthetic twin of dataset ``ds``."""
    from repro_torch.data.synthetic import make_sparse_classification
    X, y, _ = make_sparse_classification(ds.n, ds.d, ds.nnz_per_row, ds.informative,
                                         dense_features=ds.dense_features, seed=seed)
    return X, y


def lasso_config(args, ds):
    """The ``torch_sparse`` solve of a paper run: δ = 1/N², private queue
    ``two_level`` when ε > 0, else ``group_argmax``."""
    from repro_torch.core.solvers import FWConfig
    return FWConfig(backend="torch_sparse", lam=args.lam, steps=args.steps,
                    epsilon=args.epsilon, delta=1.0 / ds.n ** 2, seed=args.seed,
                    queue="two_level" if args.epsilon > 0 else "group_argmax",
                    device=args.device)


def train_lasso(args, log=print, problem=None) -> dict:
    """The paper's run on ``--dataset``'s twin (``problem``: its (X, y), made
    here from ``--seed`` unless given); returns its accuracy, nnz, last gap,
    wall seconds and coordinates."""
    from repro_torch.configs.paper_lasso import DATASETS, SMOKE
    from repro_torch.core.dp.accountant import PrivacyAccountant
    from repro_torch.core.solvers import solve
    from repro_torch.core.sparse.formats import host_to_padded
    from repro_torch.kernels.spmv import ell_matvec

    ds = (SMOKE if args.smoke else DATASETS)[args.dataset]
    X, y = problem if problem is not None else lasso_problem(ds, args.seed)
    pcsr, pcsc = host_to_padded(X, device=args.device)
    cfg = lasso_config(args, ds)
    log(f"[lasso] {ds.name}: N={ds.n} D={ds.d} nnz/row≈{ds.nnz_per_row} "
        f"T={args.steps} λ={args.lam} ε={args.epsilon} on {args.device}")
    t0 = time.time()
    res = solve((pcsr, pcsc), y, cfg)
    if args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    margins = ell_matvec(pcsr, res.w).cpu().numpy()
    acc = float(((margins > 0) == (y > 0.5)).mean())
    nnz = int((res.w != 0).sum())
    gap = float(res.gaps[-1])
    if args.epsilon > 0:
        acct = PrivacyAccountant(epsilon=args.epsilon, delta=1.0 / ds.n ** 2,
                                 total_steps=args.steps)
        acct.spend(args.steps)
        privacy = (f"privacy spent: ε={acct.spent_epsilon():.3f} of {args.epsilon} "
                   f"(δ={acct.delta:.2e})")
    else:   # the JAX launcher's accountant refuses ε = 0; a non-private run spends none
        privacy = "non-private (ε = 0)"
    log(f"[lasso] acc={acc:.4f} nnz={nnz} gap={gap:.4f} ({wall:.1f}s); {privacy}")
    return {"dataset": ds.name, "accuracy": acc, "nnz": nnz, "gap": gap, "wall_s": wall,
            "coords": res.coords.cpu().numpy().tolist()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    # lasso
    ap.add_argument("--dataset", default="rcv1")
    ap.add_argument("--lam", type=float, default=50.0)
    ap.add_argument("--epsilon", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device is available (pass --device cpu)")
    result = train_lasso(args) if args.arch == "paper-lasso" else train_lm(args)
    result.pop("state", None)
    result.pop("step_fn", None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
