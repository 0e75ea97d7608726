"""PyTorch + CUDA port of the DP Frank-Wolfe LASSO solver (``repro``'s twin).

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.

    from repro_torch import FWConfig, solve
    result = solve(X, y, FWConfig(lam=50.0, steps=500, queue="two_level"))
    results = solve_many(X, y, grid(FWConfig(backend="torch_sparse", steps=500),
                                    lam=(10.0, 50.0), epsilon=(0.5, 1.0)))
"""
from repro_torch.core.solvers import (FWConfig, FWResult, SolvePlan,  # noqa: F401
                                      available_backends, grid, plan_for, solve, solve_many)
