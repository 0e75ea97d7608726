"""Solver entry points of the port: ``solve``, ``solve_many`` over a
``grid`` of configs, the planner's ``SolvePlan``/``plan_for``, and
warm-started λ-paths (``solve_path``, ``PathResult``; ``FWConfig(lambdas=...)``
through ``solve`` and ``solve_many`` too)."""
from repro_torch.core.solvers.batched import grid, solve_many  # noqa: F401
from repro_torch.core.solvers.config import FWConfig, FWResult  # noqa: F401
from repro_torch.core.solvers.path import (PathPlan, PathResult,  # noqa: F401
                                           check_path_config, path_plan, solve_path)
from repro_torch.core.solvers.planner import SolvePlan, plan_for  # noqa: F401
from repro_torch.core.solvers.registry import (available_backends, get_backend,  # noqa: F401
                                               resolve_queue, solve)
