"""The production mesh as a plain description (port of ``repro.launch.mesh``).

The JAX package builds a ``jax.make_mesh`` of fake host devices for its dry
run.  The port's dry run needs only the mesh's axis names and sizes: the
sharding rules (``launch/sharding.py``) read nothing else, and the sharded
engine's rank grid (``distributed/collectives.py``) is the (a × b) of
``shard_grid``.  So ``make_production_mesh`` returns a ``Mesh`` that holds
no device state and no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, outermost first."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 devices a pod; ``multi_pod`` adds a leading pod = 2 axis.

    Axis roles: "pod", cross-pod data parallelism; "data", in-pod data
    parallelism; "model", tensor and expert parallelism (and the sharded
    engine's feature shards)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def shard_grid(mesh: Mesh) -> Tuple[int, int]:
    """(a, b) of the sharded engine on ``mesh``: a = pod·data row shards
    (its ``"rows"`` axis), b = model feature shards (its ``"model"``)."""
    sizes = mesh.sizes
    return sizes.get("pod", 1) * sizes.get("data", 1), sizes["model"]
