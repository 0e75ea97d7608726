"""Solver entry points of the port."""
from repro_torch.core.solvers.config import FWConfig, FWResult  # noqa: F401
from repro_torch.core.solvers.registry import (available_backends, get_backend,  # noqa: F401
                                               resolve_queue, solve)
