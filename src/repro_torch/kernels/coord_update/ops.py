"""``coord_update``: one Frank-Wolfe step for the selected column (Alg 2,
lines 16-29), in place on the run's state.

On CUDA tensors it launches ``csrc/coord_update.cu`` (one specialisation per
objective; two stream-ordered kernels, counted as one launch); on CPU
tensors it runs the plain version.  ``j`` is a (1,) int32 device tensor, so
the selection never passes through the host.  The step writes its gap and
coordinate into ``gaps[slot]`` / ``coords[slot]``.  ``queue`` is the sampler
state the step refreshes: a ``TwoLevelSamplerState`` (private; priorities
scaled by ``em_scale``, groups marked for ``tl_rebuild_``) or a
``GroupArgmaxState`` (bounds ratcheted).

α is added in the CPU plain version's order (``ref.py``), bit for bit, on
either of the kernel's two routes: ``short`` (one block, a row at a time)
or ``long`` (column owners over the whole card).  The kernel picks one from
nnz[j] on the device (``route="auto"``); ``route`` forces one, and both give
the same bits.  The kernel leaves each row's γᵢ/N in ``scratch.gs`` in lane
order and counts the steps of each route in ``scratch.routes``.

A masked run passes its ``done`` (bool) and ``stop_at`` (int32) device
flags: a step that finds ``done`` set writes only the sentinels
``gaps[slot] = 0``, ``coords[slot] = -1``; the step whose gap is
``<= gap_tol`` (float32) is applied and sets ``done`` and ``stop_at = t``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.two_level import TwoLevelSamplerState
from repro_torch.kernels import _lib
from repro_torch.kernels.coord_update.ref import coord_update_ref

ROUTES = {"auto": 0, "short": 1, "long": 2}
# an owner column of more rows than this gets a block of the owners kernel,
# the others a warp
WARP_OWNER_MAX = 128
# the longest owner columns also get a slot of lane terms (S·N entries of 8 B
# in all, S the most that fits here): against a shorter column j their owner
# walks j's lanes instead of its own rows
LANE_TERMS_MAX = 1 << 24
LIGHT, HEAVY = -1, -2   # col_info kinds (ColumnKind in the source)
_EPOCH_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class CoordScratch:
    """Device scratch of the kernel for an (N, D) matrix (``coord_update_scratch``)."""

    gs: torch.Tensor        # (N,) float32 γᵢ/N of each lane of column j
    parts: torch.Tensor     # (N,) float32 γᵢ/N·⟨X[i,:], w⟩ of each lane
    rowinfo: torch.Tensor   # (N, 2) int32 (γᵢ/N bits, epoch) by row
    colstamp: torch.Tensor  # (D,) int32 epoch of the step that last touched the column
    plan: torch.Tensor      # (8,) int32 the rows kernel's word to the owners kernel
    routes: torch.Tensor    # (2,) int32 steps taken by the short and the long route
    lane_terms: torch.Tensor = None  # (S·N, 2) int32 (term bits, epoch), sized at first use
    epoch: int = 0          # stamp of the last call (incremented per call)


def coord_update_scratch(n: int, d: int, device) -> CoordScratch:
    i32 = dict(dtype=torch.int32, device=device)
    return CoordScratch(gs=torch.zeros(n, dtype=torch.float32, device=device),
                        parts=torch.zeros(n, dtype=torch.float32, device=device),
                        rowinfo=torch.zeros((n, 2), **i32), colstamp=torch.zeros(d, **i32),
                        plan=torch.zeros(8, **i32), routes=torch.zeros(2, **i32))


def _rows_ascending(indices: torch.Tensor, nnz: torch.Tensor, chunk: int = 1024) -> bool:
    """Whether the live row ids of every padded column rise strictly."""
    lanes = torch.arange(1, indices.shape[1], device=indices.device)
    for c0 in range(0, indices.shape[0], chunk):
        idx, n = indices[c0:c0 + chunk], nnz[c0:c0 + chunk]
        bad = (idx[:, 1:] <= idx[:, :-1]) & (lanes[None, :] < n[:, None])
        if bool(bad.any()):
            return False
    return True


class OwnerTable(NamedTuple):
    """Who owns which column in the kernel's long route, for one padded CSC."""

    heavy: torch.Tensor     # (H,) int32 columns of more than WARP_OWNER_MAX rows, longest first
    col_info: torch.Tensor  # (D, 2) int32 (kind, nnz); kind: the lane-term slot of the
                            # first S heavy columns, HEAVY of the others, LIGHT of the rest
    slots: int              # S


def owner_table(pcsc) -> OwnerTable:
    """``pcsc``'s owner table (on its device), built on first use and kept on it.

    Building it also checks, once per matrix, what the kernel's order rule
    assumes: every column's rows ascending (``HostCSR.tocsc`` gives that).
    """
    table = pcsc.__dict__.get("_owners")
    if table is not None:
        return table
    nnz = pcsc.nnz
    if hasattr(pcsc, "heavy_slot"):
        light = torch.where(nnz <= pcsc.width, nnz, torch.zeros_like(nnz))
        heavy_nnz = torch.zeros(pcsc.heavy_indices.shape[0], dtype=nnz.dtype, device=nnz.device)
        heavy_cols = torch.nonzero(nnz > pcsc.width).flatten()
        heavy_nnz[pcsc.heavy_slot[heavy_cols].long()] = nnz[heavy_cols]
        ok = _rows_ascending(pcsc.indices, light) and \
            _rows_ascending(pcsc.heavy_indices, heavy_nnz)
    else:
        ok = _rows_ascending(pcsc.indices, nnz)
    if not ok:
        raise ValueError("coord_update: a column's rows are not strictly ascending; "
                         "build the padded CSC with HostCSR.tocsc")
    cols = torch.nonzero(nnz > WARP_OWNER_MAX).flatten()
    cols = cols[torch.sort(nnz[cols], descending=True, stable=True).indices]
    slots = min(int(cols.numel()), LANE_TERMS_MAX // max(1, pcsc.shape[0]))
    kind = torch.full((pcsc.shape[1],), LIGHT, dtype=torch.int32, device=nnz.device)
    kind[cols] = HEAVY
    kind[cols[:slots]] = torch.arange(slots, dtype=torch.int32, device=nnz.device)
    col_info = torch.stack([kind, nnz.to(torch.int32)], 1).contiguous()
    table = pcsc._owners = OwnerTable(cols.to(torch.int32).contiguous(), col_info, slots)
    return table


def coord_update(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, *,
                 t: float, lam: float, inv_n: float, em_scale: float, loss: str,
                 gaps: torch.Tensor, coords: torch.Tensor, slot: int,
                 scratch: Optional[CoordScratch] = None, done: Optional[torch.Tensor] = None,
                 stop_at: Optional[torch.Tensor] = None, gap_tol: float = 0.0,
                 route: str = "auto") -> None:
    """``scratch``: a ``CoordScratch`` for this matrix's shape (allocated if None)."""
    obj = get_loss(loss)
    if route not in ROUTES:
        raise ValueError(f"coord_update: route must be one of {sorted(ROUTES)}, got {route!r}")
    kw = dict(t=t, lam=lam, inv_n=inv_n, em_scale=em_scale, loss=loss,
              gaps=gaps, coords=coords, slot=slot, done=done, stop_at=stop_at,
              gap_tol=gap_tol)
    if alpha.device.type == "cpu":
        coord_update_ref(j, pcsr, pcsc, y, w, w_m, g_tilde, vbar, qbar, alpha, queue, **kw)
        return
    private = isinstance(queue, TwoLevelSamplerState)
    prio = queue.v if private else queue.p
    if not obj.separable and y is None:
        raise ValueError(f"loss {loss!r} is label-coupled; pass y")
    if j.dtype != torch.int32 or coords.dtype != torch.int32:
        raise ValueError("coord_update: j and coords must be int32")
    floats = (w, w_m, g_tilde, vbar, qbar, alpha, prio, gaps, pcsr.values)
    if any(x.dtype != torch.float32 for x in floats) or (
            y is not None and not obj.separable and y.dtype != torch.float32):
        raise ValueError("coord_update: state tensors must be float32")
    if pcsr.indices.dtype != torch.int32 or pcsr.nnz.dtype != torch.int32:
        raise ValueError("coord_update: padded CSR ids must be int32")
    if not 0 <= slot < gaps.shape[0]:
        raise ValueError(f"coord_update: slot {slot} outside the output arrays")
    if (done is None) != (stop_at is None) or (done is not None and (
            done.dtype != torch.bool or stop_at.dtype != torch.int32)):
        raise ValueError("coord_update: pass both done (bool) and stop_at (int32), or neither")
    n, d = pcsr.shape
    if scratch is None:
        scratch = coord_update_scratch(n, d, alpha.device)
    if scratch.gs.shape != (n,) or scratch.colstamp.shape != (d,):
        raise ValueError(f"coord_update: scratch is not for an ({n}, {d}) matrix")
    y_arg = None if obj.separable else y
    bound = None if private else queue.bound
    touched = queue.touched if private else None
    _lib.require_cuda("coord_update", j, pcsr.indices, pcsr.values, pcsr.nnz, y_arg, w, w_m,
                      g_tilde, vbar, qbar, alpha, prio, bound, touched, gaps, coords, done,
                      stop_at, scratch.gs, scratch.parts, scratch.rowinfo, scratch.colstamp,
                      scratch.plan, scratch.routes)
    cols = _lib.col_table(pcsc)
    owners = owner_table(pcsc)
    if scratch.lane_terms is None or scratch.lane_terms.shape[0] < max(1, owners.slots * n):
        scratch.lane_terms = torch.zeros((max(1, owners.slots * n), 2), dtype=torch.int32,
                                         device=alpha.device)
    if scratch.epoch >= _EPOCH_MAX:   # stamps restart; no stale mark can match
        for stamped in (scratch.rowinfo, scratch.colstamp, scratch.lane_terms):
            stamped.zero_()
        scratch.epoch = 0
    scratch.epoch += 1
    p = _lib.ptr
    code = _lib.library().port_coord_update(
        obj.kernel_id, p(j), *cols, p(pcsr.indices), p(pcsr.values), p(pcsr.nnz),
        pcsr.indices.shape[1], p(y_arg), p(w), p(w_m), p(g_tilde), p(vbar), p(qbar),
        p(alpha), p(prio), p(bound), p(touched), queue.group_size,
        em_scale if private else 1.0, t, lam, inv_n, d, p(gaps), p(coords), slot,
        p(done), p(stop_at), gap_tol, p(scratch.gs), p(scratch.parts), p(scratch.rowinfo),
        p(scratch.colstamp), p(scratch.plan), p(scratch.routes), scratch.epoch,
        ROUTES[route], p(owners.heavy), owners.heavy.shape[0], WARP_OWNER_MAX,
        p(owners.col_info), p(scratch.lane_terms), n, _lib.stream())
    _lib.check(code, "coord_update")
    coord_update.launches += 1


def short_route_max_rows() -> int:
    """The kernel's threshold: a column of at most this many rows takes the
    short route (``SHORT_ROUTE_MAX_ROWS`` in the source; needs the library)."""
    return int(_lib.library().port_coord_update_short_route_max())


coord_update.launches = 0
