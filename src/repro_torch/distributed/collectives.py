"""The (a × b) rank grid of the sharded engine on ``torch.distributed``.

The JAX package gets its axes from ``shard_map`` over a device mesh; here
the grid is laid over the default process group: rank ``r = ai·b + bj``
holds block (ai, bj).  Two families of subgroups carry the collectives:

  * ``"model"``: the b ranks of one row shard (ai fixed), over which the
    selection gathers the shard masses and the winner's lanes are summed;
  * ``"rows"``: the a ranks of one feature shard (bj fixed), over which the
    α delta is summed (or its top-k gathered).

``psum`` over both axes runs on the whole group.  Every rank builds every
subgroup (``dist.new_group`` is collective), once per grid.

Without a process group a 1×1 grid is ``LOCAL``: each collective is the
identity and nothing is communicated.

``recorder``: a list that each ``psum`` and ``all_gather`` appends a
``Collective`` to (kind ``"all-reduce"`` or ``"all-gather"``, the axes, the
dtype and the result's bytes), on a real grid as on ``DryMesh``, rank 0 of
an (a × b) grid with no process group, which the dry run
(``core/solvers/jax_shard.py`` ``shard_dry_run``) steps alone: its ``psum``
returns a copy of its input and its ``all_gather`` ``axis_size`` copies, so
the rank runs the shapes and launches of the grid's rank 0 and records the
collectives that rank would send.  ``solve`` never takes it.  With one, even an NCCL group of one
rank, each collective goes through ``torch.distributed``, on the tensors'
own device: gloo takes CUDA tensors for ``all_reduce`` and ``all_gather``
(float32 and int64), so four ranks on one card over gloo keep their compute
and their tensors on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("rows", "model")


class Collective(NamedTuple):
    """One collective a rank sent: its kind, axes, dtype and result bytes."""

    kind: str                 # "all-reduce" | "all-gather"
    axes: Tuple[str, ...]
    dtype: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This rank's place in an (a × b) grid and the groups of its axes."""

    a: int
    b: int
    rank: int = 0
    groups: Optional[Dict[Tuple[str, ...], object]] = None   # axes → process group
    backend: Optional[str] = None                           # None: no collectives
    recorder: Optional[List[Collective]] = dataclasses.field(default=None, compare=False)

    def _record(self, kind: str, axes: Sequence[str], out: torch.Tensor) -> None:
        if self.recorder is not None:
            self.recorder.append(Collective(kind, _key(axes), str(out.dtype).split(".")[-1],
                                            out.numel() * out.element_size()))

    @property
    def ai(self) -> int:
        return self.rank // self.b

    @property
    def bj(self) -> int:
        return self.rank % self.b

    @property
    def distributed(self) -> bool:
        return self.groups is not None

    def axis_index(self, axis: str) -> int:
        return {"rows": self.ai, "model": self.bj}[axis]

    def axis_size(self, axis: str) -> int:
        return {"rows": self.a, "model": self.b}[axis]

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Σ of ``x`` over the ranks that share this rank's other axes."""
        if not self.distributed:
            return x
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[_key(axes)])
        self._record("all-reduce", axes, out)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape): ``x`` of every rank along ``axis``, in
        axis-index order."""
        if not self.distributed:
            return x.unsqueeze(0)
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, src, group=self.groups[(axis,)])
        out = torch.stack(parts)
        self._record("all-gather", (axis,), out)
        return out


@dataclasses.dataclass(frozen=True)
class DryMesh(ShardMesh):
    """Rank 0 of an (a × b) grid with no process group (the dry run's)."""

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self._record("all-reduce", axes, out)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        out = torch.stack([x.contiguous()] * self.axis_size(axis))
        self._record("all-gather", (axis,), out)
        return out


LOCAL = ShardMesh(1, 1)
_MESHES: Dict[tuple, ShardMesh] = {}


def _key(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in AXES if a in axes)


def make_mesh(a: int, b: int) -> ShardMesh:
    """The (a × b) grid over the default process group, or ``LOCAL``.

    With a group of W ranks, a·b must be W (every rank holds a block), or 1
    (every rank runs the whole problem alone, with no collectives).  With no
    group only 1×1 runs."""
    a, b = int(a), int(b)
    if a < 1 or b < 1:
        raise ValueError(f"mesh must be positive, got ({a}, {b})")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if a * b > world:
        raise ValueError(
            f"FWConfig.mesh=({a}, {b}) needs {a * b} devices but only {world} are visible "
            "(start one rank a block: torchrun or init_process_group with world size "
            f"{a * b})")
    if not grouped or a * b < world:
        if a * b > 1:
            raise ValueError(f"FWConfig.mesh=({a}, {b}) must span the process group of "
                             f"{world} ranks")
        return LOCAL
    memo = (a, b, id(dist.group.WORLD))
    if memo not in _MESHES:
        rank = dist.get_rank()
        groups: Dict[Tuple[str, ...], object] = {("rows", "model"): dist.group.WORLD}
        for ai in range(a):                       # "model": one row shard's b ranks
            g = dist.new_group([ai * b + bj for bj in range(b)])
            if ai == rank // b:
                groups[("model",)] = g
        for bj in range(b):                       # "rows": one feature shard's a ranks
            g = dist.new_group([ai * b + bj for ai in range(a)])
            if bj == rank % b:
                groups[("rows",)] = g
        _MESHES[memo] = ShardMesh(a, b, rank, groups, dist.get_backend())
    return _MESHES[memo]
