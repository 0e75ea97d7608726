"""``torch_sparse`` backend — Algorithm 2 through the port's CUDA kernels.

Port of ``repro.core.solvers.jax_sparse`` (fixed-T path):

  * setup           — ``kernels/spmv`` ``ell_rmatvec`` builds ȳ and α₀ (one
                      sweep each; one for label-coupled objectives);
  * line 15 select  — ``kernels/bsls_draw`` ``two_level_draw`` (private:
                      one launch rebuilds the group log-sum-exps the last
                      step touched, then draws), or the lazy group argmax
                      (``core/samplers/group_argmax``);
  * lines 16-29     — ``kernels/coord_update`` ``coord_update``: scalars,
                      the fused coordinate update and the queue refresh in
                      one launch.  After a chunk's last step the private
                      queue rebuilds once more (``tl_rebuild_``), so the
                      carry leaves with ``c`` current and no group touched.

The JAX ``lax.scan`` becomes a Python loop that launches kernels.  The state
lives in a mutable ``FWCarry`` and is updated in place (the JAX carry is
immutable; in place saves a copy of every state vector per step).  Each
step's gap and coordinate land in preallocated device tensors indexed by
step, so the private path runs T steps without a host synchronisation; the
non-private queue synchronises once per lazy-repair pop.

The key chain ``key, sel_t = split(key)`` depends on nothing but the key and
T, so it is computed on the host once per chunk; the draw kernel receives
each step's selection key as two uint32 arguments (one config) or as a row
of a (B, 2) device table uploaded once per chunk (lanes).

Lanes (the JAX package's vmap over a sweep group, ``batched.py``):
``fw_carry_init_lanes`` stacks B configs' carries over one setup (v̄₀, q̄₀,
α₀), each with its own EM scale and key, and ``fw_scan_chunk_lanes``
advances them together: a private step is one ``two_level_draw_lanes`` and
one ``coord_update_lanes`` launch for all lanes (the chunk's closing
rebuild one more); a non-private step pops each live lane's host queue,
writes the (B,) coordinates to the device and makes one update launch.
One config is the case B = 1 (``fw_carry_init``, ``fw_scan_chunk``: views
of a one-lane carry), which launches the single-config kernels; so each
lane's carry, outputs and key equal its own run's bit for bit.

Early stopping (``gap_tol``, ``max_seconds``) runs the masked form of the
chunk under the shared chunk loop (``stopping.drive_chunks``).  The masking is
on the device: ``coord_update`` sets the carry's ``done``/``stop_at`` on the
step whose gap is ``<= gap_tol`` and applies it; every later launch of it and
of the draw finds ``done`` set and writes only the sentinels (0.0, -1), so
the private path still runs without a host round trip.  The non-private
host queue reads ``done`` before each pop and leaves a frozen queue alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import prng
from repro_torch.core.dp.accountant import em_log_weight_scale
from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.group_argmax import (GroupArgmaxState, ga_get_next,
                                                    ga_init, ga_pop_)
from repro_torch.core.samplers.two_level import (TwoLevelSamplerState, tl_init,
                                                 tl_rebuild_)
from repro_torch.core.solvers.config import STOP_MAX_STEPS, FWConfig, FWResult
from repro_torch.core.solvers.stopping import assemble_outputs, drive_chunks, resolve_chunk
from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR, TieredCSC
from repro_torch.kernels.bsls_draw.ops import key_table, two_level_draw, two_level_draw_lanes
from repro_torch.kernels.coord_update.ops import (CoordScratch, LaneScalars, coord_update,
                                                  coord_update_lanes, coord_update_scratch,
                                                  lane_scalars)
from repro_torch.kernels.spmv.ops import ell_rmatvec

ColumnLayout = Union[PaddedCSC, TieredCSC]


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    # a tensor divisor keeps true division on CUDA, where a Python scalar
    # divisor becomes a multiplication by its reciprocal
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def fw_setup(pcsr: PaddedCSR, y: torch.Tensor, *, loss: str,
             pcsc: Optional[ColumnLayout] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Config-independent solve state (v̄₀, q̄₀, α₀) via ``ell_rmatvec``.

    Separable objectives use the ȳ decomposition; label-coupled ones carry
    the full row gradient in q̄ (α = Xᵀq̄/N, no ȳ term).  ``pcsc`` is the
    column layout the CUDA kernel gathers over.
    """
    n = pcsr.shape[0]
    obj = get_loss(loss)
    vbar0 = torch.zeros(n, dtype=pcsr.values.dtype, device=pcsr.device)
    if obj.separable:
        ybar = _div(ell_rmatvec(pcsr, y, pcsc), n)
        qbar0 = obj.split_grad(vbar0)
        alpha0 = _div(ell_rmatvec(pcsr, qbar0, pcsc), n) - ybar
    else:
        qbar0 = obj.grad(vbar0, y)
        alpha0 = _div(ell_rmatvec(pcsr, qbar0, pcsc), n)
    return vbar0, qbar0, alpha0


@dataclasses.dataclass
class FWCarry:
    """Full loop state of one Frank-Wolfe run (the JAX ``FWCarry`` fields).

    ``w_m``/``g_tilde`` are 0-d device tensors; ``key`` is the uint32[2] PRNG
    key as an int64 CPU tensor; ``done`` (bool) and ``stop_at`` (int32, the
    number of steps applied once ``done`` is set) are the early-stopping
    flags, on the device.
    """

    w: torch.Tensor
    w_m: torch.Tensor
    g_tilde: torch.Tensor
    vbar: torch.Tensor
    qbar: torch.Tensor
    alpha: torch.Tensor
    sampler: Union[TwoLevelSamplerState, GroupArgmaxState]
    key: torch.Tensor
    done: torch.Tensor
    stop_at: torch.Tensor


@dataclasses.dataclass
class LaneCarry:
    """The loop state of B configs stacked on a leading lane axis (the
    ``FWCarry`` fields): ``w``/``alpha`` (B, D), ``w_m``/``g_tilde`` (B,),
    ``vbar``/``qbar`` (B, N), the stacked sampler, ``done``/``stop_at`` (B,) on
    the device, and each lane's uint32[2] key on the host.  ``queues`` are the
    non-private lanes' host queues (views into the stacked sampler)."""

    w: torch.Tensor
    w_m: torch.Tensor
    g_tilde: torch.Tensor
    vbar: torch.Tensor
    qbar: torch.Tensor
    alpha: torch.Tensor
    sampler: Union[TwoLevelSamplerState, GroupArgmaxState]
    keys: List[Tuple[int, int]]
    done: torch.Tensor
    stop_at: torch.Tensor
    queues: Optional[List[GroupArgmaxState]] = None

    def __post_init__(self):
        if isinstance(self.sampler, GroupArgmaxState) and self.queues is None:
            self.queues = [self.sampler.lane(b) for b in range(self.lanes)]

    @property
    def lanes(self) -> int:
        return self.w.shape[0]

    def take(self, idx: Sequence[int]) -> "LaneCarry":
        """A carry of lanes ``idx`` (copies, in that order): a cohort's repack."""
        at = torch.as_tensor(list(idx), dtype=torch.long, device=self.w.device)
        pick = lambda t: t.index_select(0, at)
        s = self.sampler
        if isinstance(s, TwoLevelSamplerState):
            sampler = TwoLevelSamplerState(pick(s.v), pick(s.c), s.d, pick(s.touched))
        else:
            sampler = GroupArgmaxState(pick(s.p), pick(s.bound), s.d)
        return LaneCarry(pick(self.w), pick(self.w_m), pick(self.g_tilde), pick(self.vbar),
                         pick(self.qbar), pick(self.alpha), sampler,
                         [self.keys[i] for i in idx], pick(self.done), pick(self.stop_at))

    def result_w(self) -> torch.Tensor:
        """(B, D) iterates w·w_m of every lane."""
        return self.w * self.w_m[:, None]

    def queue(self, b: int) -> Union[TwoLevelSamplerState, GroupArgmaxState]:
        """Lane b's sampler state, as views (a non-private lane's host queue)."""
        return self.sampler.lane(b) if self.queues is None else self.queues[b]


def _as_lanes(carry: FWCarry) -> LaneCarry:
    """``carry`` as one lane, viewing its tensors (the lane loop writes through)."""
    s = carry.sampler
    one = lambda t: t[None]
    if isinstance(s, TwoLevelSamplerState):
        sampler, queues = TwoLevelSamplerState(one(s.v), one(s.c), s.d, one(s.touched)), None
    else:
        sampler, queues = GroupArgmaxState(one(s.p), one(s.bound), s.d), [s]
    return LaneCarry(one(carry.w), one(carry.w_m), one(carry.g_tilde), one(carry.vbar),
                     one(carry.qbar), one(carry.alpha), sampler,
                     [tuple(int(k) for k in carry.key)], one(carry.done), one(carry.stop_at),
                     queues)


def fw_carry_init_lanes(d: int, dtype, vbar0, qbar0, alpha0, em_scales: Sequence[float],
                        keys: Sequence, *, private: bool) -> LaneCarry:
    """Stacked carries at t = 0 of B configs over one setup (v̄₀, q̄₀, α₀),
    each with its own EM scale and key (copies: the loop mutates them)."""
    dev = alpha0.device
    lanes = len(keys)
    if len(em_scales) != lanes or lanes < 1:
        raise ValueError("fw_carry_init_lanes: one EM scale and one key per lane")
    em = torch.tensor([float(e) for e in em_scales], dtype=dtype, device=dev)
    prio = alpha0.abs()[None, :].expand(lanes, -1)
    sampler = tl_init(prio * em[:, None]) if private else ga_init(prio.clone())
    stack = lambda t: t[None].expand(lanes, *t.shape).clone()
    return LaneCarry(
        w=torch.zeros((lanes, d), dtype=dtype, device=dev),
        w_m=torch.ones(lanes, dtype=dtype, device=dev),
        g_tilde=torch.zeros(lanes, dtype=dtype, device=dev),
        vbar=stack(vbar0), qbar=stack(qbar0), alpha=stack(alpha0), sampler=sampler,
        keys=[tuple(int(k) for k in key) for key in keys],
        done=torch.zeros(lanes, dtype=torch.bool, device=dev),
        stop_at=torch.zeros(lanes, dtype=torch.int32, device=dev))


def fw_carry_init(d: int, dtype, vbar0, qbar0, alpha0, em_scale, key,
                  *, private: bool) -> FWCarry:
    """Loop carry at t = 0: lane 0 of ``fw_carry_init_lanes`` for one config."""
    lc = fw_carry_init_lanes(d, dtype, vbar0, qbar0, alpha0, [em_scale], [key],
                             private=private)
    return FWCarry(w=lc.w[0], w_m=lc.w_m[0], g_tilde=lc.g_tilde[0], vbar=lc.vbar[0],
                   qbar=lc.qbar[0], alpha=lc.alpha[0], sampler=lc.queue(0),
                   key=torch.tensor(lc.keys[0], dtype=torch.int64), done=lc.done[0],
                   stop_at=lc.stop_at[0])


def fw_scan_chunk_lanes(pcsr: PaddedCSR, pcsc: ColumnLayout, carry: LaneCarry,
                        scalars: LaneScalars, t0: int, y=None, *, steps: int, loss: str,
                        private: bool, early_stop: bool = False,
                        scratch: Optional[CoordScratch] = None
                        ) -> Tuple[LaneCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Advance B stacked carries (in place) by ``steps`` iterations after
    global step ``t0``, lane b with λ, EM scale and gap_tol ``scalars``' b;
    returns (carry, (gaps, coords)), each (B, steps).

    ``y`` (labels) is required for label-coupled objectives.  With
    ``early_stop`` the chunk is masked: the step that observes
    ``g_t <= gap_tol`` is still applied, after it the lane's carry (PRNG key
    included) stays as it was and its outputs are (0.0, -1).  The keys are
    settled after the chunk, which reads ``done`` back once.  ``scratch``: a
    ``coord_update_scratch`` for B' >= B lanes, kept by the caller across
    chunks (allocated if None).
    """
    return _scan_chunk(pcsr, pcsc, carry, scalars, t0, y, steps=steps, loss=loss,
                       private=private, early_stop=early_stop, scratch=scratch, route="auto")


def _scan_chunk(pcsr, pcsc, carry: LaneCarry, scalars: LaneScalars, t0: int, y, *,
                steps: int, loss: str, private: bool, early_stop: bool,
                scratch: Optional[CoordScratch], route: str):
    """The chunk loop of ``fw_scan_chunk_lanes``.  One lane runs the
    single-config kernels (its scalars by value, its key words as
    arguments), which alone take a forced ``route``; B > 1 lanes run the lane
    kernels, one launch of each for every lane."""
    n, d = pcsr.shape
    obj = get_loss(loss)
    if not obj.separable and y is None:
        raise ValueError(f"loss {loss!r} is label-coupled; pass y")
    lanes = carry.lanes
    if scalars.lanes != lanes:
        raise ValueError(f"fw_scan_chunk_lanes: {scalars.lanes} lanes of scalars, "
                         f"{lanes} of carry")
    if route != "auto" and lanes > 1:
        raise ValueError("coord_update: a route is forced for one config only")
    dev = carry.alpha.device
    gaps = torch.zeros((lanes, steps), dtype=torch.float32, device=dev)
    coords = torch.zeros((lanes, steps), dtype=torch.int32, device=dev)
    j = torch.zeros(lanes, dtype=torch.int32, device=dev)
    if scratch is None and dev.type == "cuda":
        scratch = coord_update_scratch(n, d, dev, lanes=None if lanes == 1 else lanes)
    chains = [prng.key_chain(key, steps) for key in carry.keys]
    mask = dict(done=carry.done, stop_at=carry.stop_at) if early_stop else {}
    if lanes == 1:
        q = carry.queue(0)
        state = [t[0] for t in (carry.w, carry.w_m, carry.g_tilde, carry.vbar, carry.qbar,
                                carry.alpha)]
        flags = {k: v[0] for k, v in mask.items()}
        if early_stop:
            flags["gap_tol"] = scalars.gap_tol[0]
        sel = chains[0][1]
        draw = lambda i: two_level_draw(q.c, q.v, sel[i], out=j, done=flags.get("done"),
                                        touched=q.touched)
        update = lambda i: coord_update(
            j, pcsr, pcsc, y, *state, q, t=float(t0 + i + 1), lam=scalars.lam[0],
            inv_n=1.0 / n, em_scale=scalars.em_scale[0], loss=loss, gaps=gaps[0],
            coords=coords[0], slot=i, scratch=scratch, route=route, **flags)
    else:
        q = carry.sampler
        sel = key_table([s for _, s in chains], dev) if private and steps else None
        draw = lambda i: two_level_draw_lanes(q.c, q.v, sel[i], out=j, done=mask.get("done"),
                                              touched=q.touched)
        update = lambda i: coord_update_lanes(
            j, pcsr, pcsc, y, carry.w, carry.w_m, carry.g_tilde, carry.vbar, carry.qbar,
            carry.alpha, q, t=float(t0 + i + 1), scalars=scalars, inv_n=1.0 / n, loss=loss,
            gaps=gaps, coords=coords, slot=i, scratch=scratch, **mask)
    picked = [0] * lanes
    for i in range(steps):
        # ---- line 15: select each lane's coordinate ------------------------------
        if private:   # the previous step's touched groups are rebuilt first
            draw(i)
        else:
            live = range(lanes)
            if early_stop:   # a frozen lane's queue stays as it is
                live = [b for b, frozen in enumerate(carry.done.tolist()) if not frozen]
                if not live:
                    coords[:, i:] = -1
                    break
            for b in live:
                picked[b] = ga_pop_(carry.queues[b])
            if lanes == 1:
                j.fill_(picked[0])
            else:
                j.copy_(torch.tensor(picked, dtype=torch.int32))
        # ---- lines 16-29 -----------------------------------------------------------
        update(i)
    if private:
        tl_rebuild_(q)   # every lane's last groups (none after done), one launch
    keys_next = [tuple(int(k) for k in key_next) for key_next, _ in chains]
    if early_stop:
        for b, (frozen, stop) in enumerate(zip(carry.done.tolist(), carry.stop_at.tolist())):
            if frozen:
                ran = min(max(stop - t0, 0), steps)
                keys_next[b] = tuple(int(k) for k in prng.key_chain(carry.keys[b], ran)[0])
    carry.keys = keys_next
    return carry, (gaps, coords)


def fw_scan_chunk(pcsr: PaddedCSR, pcsc: ColumnLayout, carry: FWCarry,
                  lam, em_scale, gap_tol, t0: int, y=None, *, steps: int, loss: str,
                  private: bool, early_stop: bool = False, route: str = "auto"
                  ) -> Tuple[FWCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Advance ``carry`` (in place) by ``steps`` iterations after global step
    ``t0``; returns (carry, (gaps, coords)) for this chunk: the one-lane case
    of ``fw_scan_chunk_lanes`` (same masking), on views of ``carry``.
    ``route`` forces ``coord_update``'s route on the card (its results do
    not depend on it)."""
    lanes = _as_lanes(carry)
    scalars = lane_scalars([lam], [em_scale], [gap_tol])
    _, (gaps, coords) = _scan_chunk(pcsr, pcsc, lanes, scalars, t0, y, steps=steps, loss=loss,
                                    private=private, early_stop=early_stop, scratch=None,
                                    route=route)
    carry.key = torch.tensor(lanes.keys[0], dtype=torch.int64)
    return carry, (gaps[0], coords[0])


def fw_scan(pcsr: PaddedCSR, pcsc: ColumnLayout, vbar0, qbar0, alpha0, lam, em_scale,
            key, gap_tol=0.0, y=None, *, steps: int, loss: str, private: bool,
            early_stop: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Whole run; returns (w, gaps, coords, stop_step)."""
    carry = fw_carry_init(pcsr.shape[1], pcsr.values.dtype, vbar0, qbar0, alpha0,
                          em_scale, key, private=private)
    carry, (gaps, coords) = fw_scan_chunk(
        pcsr, pcsc, carry, lam, em_scale, gap_tol, 0, y, steps=steps, loss=loss,
        private=private, early_stop=early_stop)
    stop_step = torch.where(carry.done, carry.stop_at, steps)
    return carry.w * carry.w_m, gaps, coords, stop_step


def em_scale_for(config: FWConfig, n_rows: int) -> float:
    """EM log-weight scale ε'·N/(2L) when the queue is the DP two-level
    sampler; 1.0 otherwise (priorities are then raw |α|).  A screened run's
    selection gets only the solve share of ε (``screening.solve_epsilon``);
    its screening rounds spend the rest."""
    if config.queue != "two_level":
        return 1.0
    from repro_torch.core.solvers.screening import solve_epsilon
    return em_log_weight_scale(
        epsilon=solve_epsilon(config), delta=config.delta, steps=config.steps,
        n_rows=n_rows, lipschitz=config.loss_fn().lipschitz)


def _chunked_fw(pcsr, pcsc, setup, config: FWConfig, em_scale: float, private: bool,
                y=None) -> FWResult:
    """Masked chunks under the shared chunk loop until the gap certificate
    lands, ``max_seconds`` expires, or T is spent."""
    carry0 = fw_carry_init(pcsr.shape[1], pcsr.values.dtype, *setup, em_scale,
                           prng.PRNGKey(config.seed), private=private)

    def advance(carry, t0, c):
        return fw_scan_chunk(pcsr, pcsc, carry, config.lam, em_scale, config.gap_tol, t0, y,
                             steps=c, loss=config.loss, private=private, early_stop=True)

    carry, outs, stop_step, stop_reason = drive_chunks(
        advance, carry0, steps=config.steps, chunk=resolve_chunk(config),
        max_seconds=config.max_seconds, done_of=lambda cy: cy.done,
        stop_at_of=lambda cy: cy.stop_at)
    gaps, coords = assemble_outputs(outs, config.steps, (0.0, -1))
    return FWResult(w=carry.w * carry.w_m, gaps=gaps, coords=coords,
                    losses=torch.zeros_like(gaps), stop_step=stop_step,
                    stop_reason=stop_reason)


def _sync(device) -> None:
    """Wait for ``device``'s work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _screened_chunked_fw(pcsr, pcsc, setup, config: FWConfig, em_scale: float, private: bool,
                         y=None) -> FWResult:
    """The chunk loop with a pair that changes between chunks (screening).

    The pair lives in a ``stopping.ChunkGeometry`` that ``advance`` reads
    per chunk.  At every ``screen_every``-th boundary ``respec`` releases
    |α| through the keep rule, repacks the pair and the carry to the
    survivors on their device and swaps them in; the next chunks run at the
    smaller D, and the kernels build their per-matrix tables (``ell_rmatvec``'s
    segments, ``coord_update``'s owners) for the new pair at first use.  The
    outputs are mapped to the original feature ids per chunk (``out_map``,
    before the boundary's repack) and the final w is expanded to D₀.  Each
    chunk's time goes to the planner's cost book against the current pair's
    stats.  The swapped-out pair is freed; the caller's pair stays.
    """
    import time

    from repro_torch.core.solvers.autotune import platform_of
    from repro_torch.core.solvers.planner import data_stats, record_cost
    from repro_torch.core.solvers.screening import (Screener, pair_bytes, repack_carry,
                                                    repack_pair)
    from repro_torch.core.solvers.stopping import ChunkGeometry
    from repro_torch.kernels.coord_update.ops import owner_table

    n, d = pcsr.shape
    geom = ChunkGeometry(operands=(pcsr, pcsc), d=d, pad_row=int(pcsr.indices.shape[1]),
                         pad_col=pcsc.full_width)
    scr = Screener(config, d=d, n_rows=n, row_width=int(pcsr.indices.shape[1]),
                   em_scale=em_scale, private=private)
    carry0 = fw_carry_init(d, pcsr.values.dtype, *setup, em_scale, prng.PRNGKey(config.seed),
                           private=private)
    platform = platform_of(pcsr.device)
    stats = {}

    def cur_stats():
        if geom.version not in stats:
            stats[geom.version] = data_stats(geom.operands)
        return stats[geom.version]

    def advance(carry, t0, c):
        p, q = geom.operands
        tw = time.perf_counter()
        carry, out = fw_scan_chunk(p, q, carry, config.lam, em_scale, config.gap_tol, t0, y,
                                   steps=c, loss=config.loss, private=private, early_stop=True)
        _sync(out[0].device)
        record_cost("torch_sparse", "sequential", platform, cur_stats(),
                    (time.perf_counter() - tw) / c, loss=config.loss)
        return carry, out

    def out_map(out, t0):
        gaps, coords = out
        return gaps, scr.map_coords(coords)

    def respec(carry, t0, n_chunks):
        if not scr.due(n_chunks):
            return None
        keep = scr.screen(carry.alpha.abs().cpu().numpy(), (carry.w != 0).cpu().numpy())
        if keep is None:
            return None
        tw = time.perf_counter()
        p2, q2 = repack_pair(*geom.operands, keep)
        carry2 = repack_carry(carry, keep, em_scale, private)
        _sync(carry2.alpha.device)
        repack_s = time.perf_counter() - tw
        facts = {"pair_bytes": pair_bytes((p2, q2))}
        if q2.device.type == "cuda":   # the next chunk's first launch needs it
            tw = time.perf_counter()
            owner_table(q2)
            _sync(q2.device)
            facts["owner_table_seconds"] = time.perf_counter() - tw
        geom.swap((p2, q2), p2.shape[1], pad_row=int(p2.indices.shape[1]),
                  pad_col=q2.full_width)
        return carry2, scr.commit(keep, repack_seconds=repack_s, **facts)

    carry, outs, stop_step, stop_reason = drive_chunks(
        advance, carry0, steps=config.steps, chunk=resolve_chunk(config),
        max_seconds=config.max_seconds, done_of=lambda cy: cy.done,
        stop_at_of=lambda cy: cy.stop_at, respec=respec, out_map=out_map)
    gaps, coords = assemble_outputs(outs, config.steps, (0.0, -1))
    return FWResult(w=scr.expand(carry.w * carry.w_m), gaps=gaps, coords=coords,
                    losses=torch.zeros_like(gaps), stop_step=stop_step,
                    stop_reason=stop_reason)


def torch_sparse_fw(pcsr: PaddedCSR, pcsc: ColumnLayout, y: torch.Tensor,
                    config: FWConfig, setup=None) -> FWResult:
    """One solve through the kernels: fixed T in one chunk, or the chunked
    chunk loop when the config can stop early — the same arithmetic per step,
    so the iterates agree bit for bit at every prefix.  A screened config
    (``screen_every > 0``) runs ``_screened_chunked_fw``.

    ``setup`` injects a precomputed (v̄₀, q̄₀, α₀), which must be what
    ``fw_setup`` would compute for (X, y, loss).
    """
    n, _ = pcsr.shape
    private = config.queue == "two_level"
    em_scale = em_scale_for(config, n)
    y_scan = None if config.loss_fn().separable else y
    if setup is None:
        setup = fw_setup(pcsr, y, loss=config.loss, pcsc=pcsc)
    if config.screen_every > 0:   # the pair changes between chunks
        return _screened_chunked_fw(pcsr, pcsc, setup, config, em_scale, private, y=y_scan)
    if config.early_stopping:
        return _chunked_fw(pcsr, pcsc, setup, config, em_scale, private, y=y_scan)
    w, gaps, coords, _ = fw_scan(
        pcsr, pcsc, *setup, config.lam, em_scale, prng.PRNGKey(config.seed), 0.0, y_scan,
        steps=config.steps, loss=config.loss, private=private)
    return FWResult(w=w, gaps=gaps, coords=coords, losses=torch.zeros_like(gaps),
                    stop_step=config.steps, stop_reason=STOP_MAX_STEPS)
