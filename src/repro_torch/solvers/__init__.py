"""repro_torch.solvers — the solver API of the port.

    from repro_torch import solvers
    from repro_torch.data import linsys
    sys_ = linsys.conditioned_gaussian(n=128, m=4, cond=20.0)   # on cuda
    res = solvers.get("apc").solve(
        sys_, iters=500, plan=solvers.ExecutionPlan(kernel=True))
    solvers.available()   # ['apc'] in this slice
    res = solvers.get("apc").solve_many(sys_, B)                # B: (k, N)
"""
from .api import Solver, SolveResult, iters_to_tolerance  # noqa: F401
from .capability import (CapabilityError, ExecutionPlan,  # noqa: F401
                         resolve_plan)
from .registry import available, get, register  # noqa: F401

# Importing the implementation module populates the registry.
from . import projection  # noqa: F401, E402
