"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``spmv.ell_matvec``, ``spmv.ell_rmatvec``, ``bsls_draw.two_level_draw`` and
``coord_update.coord_update`` launch their kernel for CUDA tensors and run
the plain version for CPU tensors.  Each wrapper counts its launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.bsls_draw.ops import two_level_draw
from repro_torch.kernels.coord_update.ops import coord_update
from repro_torch.kernels.spmv.ops import ell_matvec, ell_rmatvec

WRAPPERS = {"ell_matvec": ell_matvec, "ell_rmatvec": ell_rmatvec,
            "two_level_draw": two_level_draw, "coord_update": coord_update}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
