"""Roofline terms of the port (``repro.roofline.analysis``, without the HLO
parser): the three-term bound the solver planner feeds with per-step counts."""
from repro_torch.roofline.analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS,  # noqa: F401
                                           model_flops, roofline_terms, two_point_total)
