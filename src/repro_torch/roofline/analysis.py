"""Three-term roofline model (copy of ``repro.roofline.analysis`` for the port).

Hardware constants: one NVIDIA H100 SXM (80GB HBM3) at its full 700 W power
limit, from NVIDIA's data sheet — 67 TFLOP/s float32 outside the tensor
cores (the solver's arithmetic), 989 TFLOP/s bf16 dense on the tensor
cores, 3.35 TB/s HBM3, and NVLink at 450 GB/s each way to every other card
of the host.  A card set below 700 W runs slower under load
(``nvidia-smi --query-gpu=power.limit``).

``roofline_terms`` is the cost kernel of the solver planner
(``repro_torch.core.solvers.planner``): per-Frank-Wolfe-step FLOP and byte
counts go through the same three-term bound, with the planner's CPU
constants substituted through the ``peak_flops``/``hbm_bw`` keywords on the
CPU.  The solver's work is float32, so the float32 peak is the default.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM 80GB HBM3, 700 W (data sheet, dense rates)
PEAK_FLOPS = 67e12          # float32 FLOP/s, CUDA cores
PEAK_FLOPS_BF16 = 989e12    # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12            # bytes/s of HBM3
NVLINK_BW = 450e9           # bytes/s each way, to each other card of the host


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective_bytes: float, chips: int,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = NVLINK_BW) -> Dict[str, float]:
    """The three roofline times (seconds) + dominant bottleneck.

    ``flops``/``bytes_accessed`` are per device, so the per-card rates apply
    directly; ``collective_bytes`` is per-device bytes crossing its busiest
    link (2× for links that carry both ways at once).
    """
    t_comp = flops / peak_flops
    t_mem = bytes_accessed / hbm_bw
    t_coll = collective_bytes / (2.0 * link_bw)
    terms = {"t_compute_s": t_comp, "t_memory_s": t_mem,
             "t_collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    terms["bottleneck"] = {"t_compute_s": "compute", "t_memory_s": "memory",
                           "t_collective_s": "collective"}[dominant]
    terms["t_bound_s"] = max(t_comp, t_mem, t_coll)
    terms["roofline_fraction"] = (t_comp / terms["t_bound_s"]
                                  if terms["t_bound_s"] > 0 else 0.0)
    return terms


def model_flops(n_params: float, tokens: float, *, active_params: Optional[float] = None,
                training: bool = True) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference); MoE uses N_active."""
    n = active_params if active_params is not None else n_params
    return (6.0 if training else 2.0) * n * tokens


def two_point_total(cost_l1: float, cost_l2: float, l1: int, l2: int,
                    l_target: int) -> float:
    """Extrapolate a per-layer-homogeneous cost to the full layer count."""
    per_layer = (cost_l2 - cost_l1) / max(l2 - l1, 1)
    return cost_l1 + (l_target - l1) * per_layer
