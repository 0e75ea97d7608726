"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``spmv.ell_matvec``, ``spmv.ell_rmatvec``, ``bsls_draw.two_level_draw``,
``coord_update.coord_update``, ``flash_attention.flash_attention`` and
``scatter.scatter_add_ordered`` (an in-order scatter-add, the repair of the
card's scatter order, with no Pallas counterpart) launch
their kernel for CUDA tensors and run the plain version for CPU tensors;
``bsls_draw.two_level_draw_lanes`` and ``coord_update.coord_update_lanes``
are the lane forms of the draw and the update (B configs of a sweep group
in one launch).
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``; ``flash_attention``, which has a kernel per dtype,
also counts each route in ``flash_attention.routes`` (its backward,
``flash_attention.flash_attention_bwd``, in ``flash_attention_bwd.routes``), and the draw kernel's
rebuild-only launches (``bsls_draw.rebuild_touched``) count in
``two_level_draw.rebuilds`` (``two_level_draw_lanes.rebuilds`` for stacked
state).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.bsls_draw.ops import two_level_draw, two_level_draw_lanes
from repro_torch.kernels.coord_update.ops import coord_update, coord_update_lanes
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
from repro_torch.kernels.scatter.ops import scatter_add_ordered
from repro_torch.kernels.spmv.ops import ell_matvec, ell_rmatvec

WRAPPERS = {"ell_matvec": ell_matvec, "ell_rmatvec": ell_rmatvec,
            "two_level_draw": two_level_draw, "coord_update": coord_update,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "two_level_draw_lanes": two_level_draw_lanes,
            "coord_update_lanes": coord_update_lanes,
            "scatter_add_ordered": scatter_add_ordered}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    flash_attention.routes = dict.fromkeys(flash_attention.routes, 0)
    flash_attention_bwd.routes = dict.fromkeys(flash_attention_bwd.routes, 0)
    two_level_draw.rebuilds = 0
    two_level_draw_lanes.rebuilds = 0
