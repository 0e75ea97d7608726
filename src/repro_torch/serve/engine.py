"""Batched serving engine: continuous batching over a fixed-slot KV cache
(port of ``repro.serve.engine``).

  * a fixed number of **slots** (the decode batch dimension) hold in-flight
    requests;
  * **prefill** zeroes the slot's rows of every cache buffer (KV, recurrent
    state, conv window), then runs one request at a time through
    ``decode_step`` over its prompt's tokens, writing the slot's rows of the
    batched cache in place (the token-parallel prefill is the model's
    ``forward``).  The JAX engine scans its bucket, padding included, from
    the slot's old state: the same tokens for a KV cache, whose padded rows
    are rewritten before they are read, and other tokens for a recurrent
    state, which takes in the padding (ROADMAP.md C);
  * **decode** steps all slots together: one batched ``decode_step`` with a
    (slots,) position tensor, each slot at its own position (the JAX engine
    ``vmap``s a scalar-position step over the slots instead);
  * finished requests (EOS or max_tokens) free their slot at once; the
    scheduler admits the longest-waiting request first (FCFS).

The encoder-decoder family is refused: the engine has no slot axis for its
cross memory and a ``Request`` carries no frames (serve it through
``encdec.prefill_cross`` and ``decode_step``; the JAX engine cannot serve it
either).

Sampling: the first token of a request is the argmax of its last prompt
logit; later tokens are greedy, or with ``greedy=False`` drawn as
``jax.random.categorical`` draws them — argmax of logits / temperature plus
Gumbel noise from the engine's threefry key chain (``repro_torch.prng``), so
the port draws the JAX engine's tokens from the same seed and logits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int = 32
    eos_id: int = -1                   # -1 → never matches (length-capped)
    # filled by the engine
    generated: Optional[List[int]] = None
    submitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def done(self) -> bool:
        if self.generated is None:
            return False
        return (len(self.generated) >= self.max_new_tokens
                or (self.eos_id >= 0 and self.eos_id in self.generated))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8                     # decode batch size
    max_len: int = 2048                # cache capacity per slot
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0


class ServingEngine:
    """Single-controller continuous-batching engine over a ``ModelAPI``."""

    def __init__(self, api, params, config: ServeConfig):
        if api.cfg.family == "encdec":
            raise ValueError("ServingEngine: the encdec family is not served: the engine has "
                             "no slot axis for the cross memory and a Request has no frames "
                             "(use encdec.prefill_cross and decode_step)")
        self.api = api
        self.params = params
        self.cfg = config
        self.device = api.device
        self.cache = api.init_cache(config.slots, config.max_len)
        self.pos = np.zeros(config.slots, np.int64)        # next write index
        self.live: List[Optional[Request]] = [None] * config.slots
        self.queue: List[Request] = []
        self.key = prng.PRNGKey(config.seed)
        self.steps = 0
        self.prefills = 0

    # ------------------------------------------------------------------ public
    def submit(self, req: Request) -> None:
        p = len(req.prompt)
        if not 0 < p < self.cfg.max_len:
            raise ValueError(f"ServingEngine: a prompt of {p} tokens; the cache holds "
                             f"{self.cfg.max_len} a slot")
        req.submitted_at = time.time()
        req.generated = []
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain; returns finished requests."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._admit()
            if not any(r is not None for r in self.live):
                if not self.queue:
                    break
                continue
            self._step(finished)
        return finished

    # ------------------------------------------------------------------ internals
    def _admit(self) -> None:
        for slot in range(self.cfg.slots):
            if self.live[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self._prefill_into_slot(req, slot)
            self.live[slot] = req

    def _slot_cache(self, slot: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Views of one slot's rows (axis 1 of every (L, slots, ...) buffer):
        a decode step on them writes the batched cache in place."""
        return {group: {name: buf[:, slot:slot + 1] for name, buf in bufs.items()}
                for group, bufs in self.cache.items()}

    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        """Run the prompt through decode steps into this slot's zeroed rows."""
        p = len(req.prompt)
        toks = torch.from_numpy(np.asarray(req.prompt, np.int64)).to(self.device)
        slot_cache = self._slot_cache(slot)
        for bufs in slot_cache.values():
            for buf in bufs.values():
                buf.zero_()
        for i in range(p):
            logits, _ = self.api.decode_step(self.params, slot_cache, toks[i:i + 1, None], i)
        self.pos[slot] = p
        # first generated token from the last prompt logit
        req.generated.append(int(torch.argmax(logits[0, 0])))
        self.prefills += 1

    def _step(self, finished: List[Request]) -> None:
        toks = np.zeros((self.cfg.slots, 1), np.int64)
        pos = np.zeros(self.cfg.slots, np.int64)
        for s, req in enumerate(self.live):
            if req is not None:
                toks[s, 0] = req.generated[-1]
                pos[s] = self.pos[s]
        logits, self.cache = self.api.decode_step(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        logits = logits[:, 0].float().cpu()                      # (slots, V)
        self.steps += 1
        for s, req in enumerate(self.live):
            if req is None:
                continue
            self.pos[s] += 1
            if self.cfg.greedy:
                nxt = int(torch.argmax(logits[s]))
            else:
                self.key, sub = prng.split2(self.key)
                noise = prng.gumbel(sub, logits[s].shape)
                nxt = int(torch.argmax(noise + logits[s] / self.cfg.temperature))
            req.generated.append(nxt)
            if req.done or self.pos[s] >= self.cfg.max_len - 1:
                req.finished_at = time.time()
                finished.append(req)
                self.live[s] = None
