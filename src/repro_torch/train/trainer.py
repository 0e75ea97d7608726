"""Training step builder and host training loop (port of ``repro.train.trainer``).

``make_train_step(loss_fn, tc)`` returns ``(state, batch) -> (state,
metrics)``: the loss and its gradients by ``torch.autograd`` over the
parameter leaves (each block recomputed in the backward when ``tc.remat``;
the attention's gradient from the flash kernel's backward on the card),
global-norm clip, the schedule's lr, the optimizer update.  Microbatches
(gradient accumulation) add each slice's gradients in float32, so the
memory high-water mark is one microbatch of activations.  A step whose loss
or gradient norm is not finite keeps the old parameters and optimizer
state (fault tolerance: a bad batch does not poison the run); its step
still counts, as in the JAX package.

``fit`` adds the host concerns: checkpoint rotation through
``repro_torch.checkpoint``, a per-step watchdog (straggler logging) and
the ``obs`` span ``train.fit``, histogram ``train.step_seconds``, event
``train.straggler``, counters ``train.stragglers`` and
``train.skipped_steps`` and span ``train.checkpoint``.

``TrainState.stacked`` names the parameter tree's layer groups that the
JAX package stacks (``interop.stacked_groups(cfg)``): the optimizer state
and checkpoints take JAX's layout from it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from repro_torch import obs
from repro_torch.train.optimizer import (Optimizer, clip_by_global_norm, get_optimizer,
                                         make_schedule)
from repro_torch.train.tree import tree_leaves, tree_unflatten

Tree = Any


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor           # int32 scalar
    params: Tree
    opt_state: Dict[str, Any]
    stacked: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    schedule: str = "cosine"     # cosine | wsd | constant
    total_steps: int = 10_000
    warmup: int = 100
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient-accumulation factor
    remat: bool = True
    # cast the gradients to this dtype (the JAX package's cross-replica
    # reduction dtype; the optimizer's arithmetic stays float32)
    grad_reduce_dtype: str = ""  # "" = keep native; "bfloat16" to compress


def make_train_state(params, opt: Optimizer, stacked: Iterable[str] = ()) -> TrainState:
    """Step 0, the parameters as autograd leaves, the optimizer's fresh state."""
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    stacked = tuple(stacked)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt_state=opt.init(params, stacked), stacked=stacked)


def _slice(batch, i: int, n: int):
    def part(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: part(v) for k, v in batch.items()}


def make_train_step(loss_fn: Callable, tc: TrainConfig) -> Callable:
    """loss_fn(params, batch, remat=...) -> scalar.  Returns the step."""
    opt = get_optimizer(tc.optimizer)
    schedule = make_schedule(tc.schedule, tc.peak_lr, tc.total_steps, tc.warmup)
    reduce_dtype = getattr(torch, tc.grad_reduce_dtype) if tc.grad_reduce_dtype else None

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch, remat=tc.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if reduce_dtype is not None:
            grads = [g.to(reduce_dtype) for g in grads]
        return loss.detach().float(), grads

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if tc.microbatches > 1:
            loss_sum = torch.zeros((), dtype=torch.float32)
            g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            for i in range(tc.microbatches):
                loss, g = grads_of(params, _slice(batch, i, tc.microbatches))
                g_sum = [a + b.float() for a, b in zip(g_sum, g)]
                loss_sum = loss_sum + loss.cpu()
            loss = loss_sum / tc.microbatches
            grads = [g / tc.microbatches for g in g_sum]
        else:
            loss, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads), tc.grad_clip)
        lr = schedule(int(state.step))
        loss_v, gnorm_v = float(loss), float(gnorm)
        ok = bool(torch.isfinite(torch.tensor([loss_v, gnorm_v])).all())
        if ok:   # a skipped step keeps the parameters and the optimizer state
            opt.update(grads, state.opt_state, params, lr, state.stacked)
        new_state = dataclasses.replace(state, step=state.step + 1)
        metrics = {"loss": loss_v, "grad_norm": gnorm_v, "lr": lr, "skipped": float(not ok)}
        return new_state, metrics

    return step_fn


def fit(state: TrainState, step_fn: Callable, batches, *,
        steps: int, checkpointer=None, ckpt_every: int = 200,
        log_every: int = 10, watchdog_s: float = 600.0,
        log: Callable[[str], None] = print) -> Tuple[TrainState, list]:
    """Host training loop with checkpoint rotation and straggler watchdog.

    ``log=`` is the text sink (``print`` by default).  A step's seconds are
    its host clock up to the metrics' read, which waits for the card.
    """
    history = []
    with obs.span("train.fit", steps=steps):
        for i in range(steps):
            t0 = time.time()
            batch = next(batches)
            state, metrics = step_fn(state, batch)
            dt = time.time() - t0
            obs.observe("train.step_seconds", dt)
            if dt > watchdog_s:
                obs.event("train.straggler", step=int(state.step), sec=dt,
                          watchdog_s=watchdog_s)
                obs.count("train.stragglers")
                log(f"[watchdog] step {int(state.step)} took {dt:.1f}s "
                    f"(> {watchdog_s}s) — straggler detected; continuing")
            if i % log_every == 0 or i == steps - 1:
                m = dict(metrics)
                history.append({"step": int(state.step), **m, "sec": dt})
                if m.get("skipped"):
                    obs.count("train.skipped_steps")
                log(f"step {int(state.step):>6d}  loss={m['loss']:.4f}  "
                    f"gnorm={m['grad_norm']:.3f}  lr={m['lr']:.2e}  "
                    f"{dt*1e3:.0f}ms")
            if checkpointer is not None and int(state.step) % ckpt_every == 0:
                with obs.span("train.checkpoint", step=int(state.step)):
                    checkpointer.save(state)
    return state, history
