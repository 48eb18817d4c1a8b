"""repro_torch.solvers — the solver API of the port.

    from repro_torch import solvers
    from repro_torch.data import linsys
    sys_ = linsys.conditioned_gaussian(n=128, m=4, cond=20.0)   # on cuda
    res = solvers.get("apc").solve(
        sys_, iters=500, plan=solvers.ExecutionPlan(kernel=True))
    solvers.available()   # the reference's eight solvers
    res = solvers.get("cimmino").solve_many(sys_, B)            # B: (k, N)

Cached factorizations and request serving (the serve-traffic hot path):

    store = solvers.FactorStore(directory="/ckpt/factors")
    res = solvers.get("apc").solve(
        sys_, plan=solvers.ExecutionPlan(store=store))          # hit after 1st
    srv = solvers.LinsysServer(store, solver="apc", batch=4, use_kernel=True)
    fp = srv.register(sys_)
    srv.submit(fp, b); srv.drain()                 # coalesced, captured
    asrv = solvers.AsyncLinsysServer(store, solver="apc", batch=4,
                                     pipeline_depth=2)
    with asrv:
        tickets = [asrv.submit(fp, b) for b in stream]
"""
from .api import Solver, SolveResult, iters_to_tolerance  # noqa: F401
from .capability import (CapabilityError, ExecutionPlan,  # noqa: F401
                         resolve_plan)
from .registry import available, get, register  # noqa: F401

# Importing the implementation modules populates the registry.
from . import admm, gradient, projection  # noqa: F401, E402
from .store import BlockReuse, FactorStore, fingerprint  # noqa: F401, E402
from .serve import LinsysServer, StreamReport, solve_stream  # noqa: F401, E402
from .pipeline import AsyncLinsysServer, Shed, Ticket  # noqa: F401, E402
