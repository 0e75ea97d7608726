"""FLOP and collective counts of the port's programs (counterpart of ``repro.roofline.hlo``).

The JAX package reads its counts from the compiler: ``cost_analysis()`` of
an executable for FLOPs and bytes accessed, and the collectives of the
optimized HLO text, with each while loop's body multiplied by its trip
count (``collective_bytes_nested``).  The port has no SPMD compiler, so each
count comes from the port's own program:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step, run on
  ``meta`` tensors for shapes only (``step_flops``).  The mode counts the
  matrix products, and the flash-attention ops by their registered formula
  (``kernels/flash_attention/ops.py``), the same on ``meta`` as on the CPU.
  Python loops unroll every layer, so the count is the full depth's.
* Collectives: the sharded engine's ``ShardMesh`` recorder, which logs what
  ``distributed/fw_shard.py`` sends (``collective_bytes`` over the run,
  ``collective_bytes_flat`` over the setup and one step).
* Bytes accessed: no counterpart.  XLA counts the bytes its fused kernels
  read and write; eager PyTorch fuses nothing and no tool here counts
  a kernel's traffic, so the dry run reports it as ``None``.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed.collectives import Collective
from repro_torch.train.trainer import TrainConfig, microbatch, microbatch_grads
from repro_torch.train.tree import tree_leaves


def step_flops(api, kind: str, params, inputs: Dict[str, torch.Tensor], *,
               cache=None, microbatches: int = 1, remat: bool = True) -> int:
    """FLOPs of one step of ``api`` (a ``models.registry.ModelAPI``) on
    ``params`` and ``inputs`` (``meta`` tensors, or real ones on the CPU):

    train    ``lm_loss`` and its backward over the ``microbatches`` slices,
             under ``remat``, as ``train.trainer.make_train_step`` runs
             them (the optimizer's update is not counted);
    prefill  ``forward(last_only=True)``;
    decode   one ``decode_step`` on ``cache`` at ``inputs["pos"]``.
    """
    with FlopCounterMode(display=False) as mode:
        if kind == "train":
            for leaf in tree_leaves(params):
                leaf.requires_grad_(True)
            tc = TrainConfig(remat=remat, microbatches=microbatches)
            for i in range(microbatches):
                microbatch_grads(api.loss, tc, params, microbatch(inputs, i, microbatches))
        else:
            with torch.no_grad():
                if kind == "prefill":
                    batch = inputs if api.cfg.family == "encdec" else inputs["tokens"]
                    api.forward(params, batch, last_only=True)
                elif kind == "decode":
                    api.decode_step(params, cache, inputs["tokens"], inputs["pos"])
                else:
                    raise ValueError(f"step_flops: unknown step kind {kind!r}")
    return int(mode.get_total_flops())


def collective_bytes(records: Iterable[Collective]) -> Dict[str, int]:
    """Result bytes of every recorded collective, by kind (the counterpart
    of ``collective_bytes_nested``: each loop step counted)."""
    out: Dict[str, int] = {}
    for c in records:
        out[c.kind] = out.get(c.kind, 0) + c.nbytes
    return out


def collective_bytes_flat(run) -> Dict[str, int]:
    """The setup's and one step's collectives of a ``ShardDryRun``, by kind:
    the counterpart of the JAX dry run's ``collective_bytes``, which reads
    a loop's body once."""
    return collective_bytes(run.setup + run.step)


def collectives_per_step(run) -> Dict[str, int]:
    """How many collectives of each kind one step sends."""
    out: Dict[str, int] = {}
    for c in run.step:
        out[c.kind] = out.get(c.kind, 0) + 1
    return out

