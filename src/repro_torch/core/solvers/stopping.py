"""The chunked early-stopping loop shared by the port's backends
(``repro.core.solvers.stopping`` counterpart).

The masked chunk loops live with their engines (``fw_dense._dense_chunk``,
``torch_sparse.fw_scan_chunk``); what they share is ``drive_chunks``, a host
loop that advances one chunk of steps at a time until the device ``done``
flag is set, the wall clock runs out, or T is spent, and ``assemble_outputs``,
which pads the output arrays to full length with sentinels (0.0 gaps, -1
coords).  Reading ``done`` after a chunk is the only host synchronisation
the loop adds.

The telemetry calls of the JAX ``drive_chunks`` (``repro.obs``) are left out
until the port has ``obs`` (ROADMAP.md item A11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.solvers.config import (STOP_GAP_TOL, STOP_MAX_SECONDS,
                                             STOP_MAX_STEPS, FWConfig)


def default_chunk(steps: int) -> int:
    """Chunk length when the config pins none: T/8 clamped to [8, 256]
    (a copy of ``repro.core.solvers.planner.default_chunk``)."""
    return max(1, min(max(8, steps // 8), 256, steps))


def resolve_chunk(config: FWConfig) -> int:
    """The config's ``chunk_steps`` (clamped to [1, T]) or the default."""
    if config.chunk_steps is not None:
        return max(1, min(int(config.chunk_steps), config.steps))
    return default_chunk(config.steps)


@dataclasses.dataclass
class ChunkGeometry:
    """The operands a chunked run advances over, swappable between chunks.

    ``advance`` closures read ``operands`` through this cell; a ``respec``
    hook may replace them with :meth:`swap` (the screening repack of
    ROADMAP.md item A8).  ``version`` counts swaps.
    """

    operands: tuple
    d: int
    pad_row: int = 0
    pad_col: int = 0
    version: int = 0

    def swap(self, operands: tuple, d: int, pad_row: int = 0, pad_col: int = 0) -> None:
        self.operands = operands
        self.d = int(d)
        self.pad_row = int(pad_row)
        self.pad_col = int(pad_col)
        self.version += 1


def drive_chunks(
    advance: Callable,      # (carry, t0, chunk_len) -> (carry, outs tuple)
    carry,
    *,
    steps: int,
    chunk: int,
    max_seconds: Optional[float],
    done_of: Callable,      # carry -> device bool: certificate landed
    stop_at_of: Callable,   # carry -> device int: steps applied at freeze
    clock: Callable[[], float] = time.perf_counter,
    respec: Optional[Callable] = None,
    out_map: Optional[Callable] = None,
) -> Tuple[object, List[Tuple[torch.Tensor, ...]], int, str]:
    """Advance chunks until the run ends.

    Returns ``(carry, chunk_outputs, stop_step, stop_reason)``, with
    ``chunk_outputs`` the per-chunk output tuples in order.

    The ``max_seconds`` clock starts after the first chunk returns: that
    chunk carries the one-off cost of the process's first launches (the
    ``nvcc`` build of the kernels at first use), which is not this run's.
    ``clock`` injects the time source.  ``respec(carry, t0, n_chunks)`` is
    called at each interior boundary the run continues past and returns
    ``None`` or ``(new_carry, info)``; ``out_map(out, t0)`` maps each
    chunk's outputs before they are kept, and before that boundary's
    ``respec``.
    """
    outs: List[Tuple[torch.Tensor, ...]] = []
    t0, stop_reason = 0, STOP_MAX_STEPS
    t_start: Optional[float] = None
    n_chunks = 0
    while t0 < steps:
        c = min(chunk, steps - t0)
        carry, out = advance(carry, t0, c)
        out = out if isinstance(out, tuple) else (out,)
        if out_map is not None:
            out = out_map(out, t0)
        outs.append(out)
        t0 += c
        n_chunks += 1
        done = bool(done_of(carry))         # synchronises: the chunk has run
        now = clock()
        if done:
            stop_reason = STOP_GAP_TOL
            break
        if t_start is None:                 # first chunk: one-off costs excluded
            t_start = now
        elif max_seconds is not None and now - t_start >= max_seconds:
            stop_reason = STOP_MAX_SECONDS
            break
        if respec is not None and t0 < steps:
            swapped = respec(carry, t0, n_chunks)
            if swapped is not None:
                carry, _ = swapped
    stop_step = int(stop_at_of(carry)) if bool(done_of(carry)) else t0
    return carry, outs, stop_step, stop_reason


def assemble_outputs(chunk_outputs: Sequence[Tuple[torch.Tensor, ...]], steps: int,
                     pad_values: Sequence) -> Tuple[torch.Tensor, ...]:
    """Concatenate the per-chunk output streams and pad each to ``steps``
    with its sentinel ``pad_values[i]`` (0.0 for gaps, -1 for coords);
    float sentinels give float32 streams, int sentinels int32 ones.  Steps a
    chunk ran past the stop are already sentinels (the masked step writes
    them)."""
    streams = []
    for i, pad in enumerate(pad_values):
        parts = [out[i] for out in chunk_outputs]
        dtype = torch.int32 if isinstance(pad, int) else torch.float32
        arr = torch.cat(parts) if parts else torch.zeros(0, dtype=dtype)
        if arr.shape[0] < steps:
            arr = torch.cat([arr, torch.full((steps - arr.shape[0],), pad, dtype=arr.dtype,
                                             device=arr.device)])
        streams.append(arr)
    return tuple(streams)
