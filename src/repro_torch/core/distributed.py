"""Mesh-distributed APC over raw shards — a thin shim over
``repro_torch.solvers.mesh`` (counterpart of ``repro.core.distributed``).

The general mesh backend is ``repro_torch.solvers.mesh``: any registered
solver runs sharded through ``solvers.get(name).solve(sys,
plan=ExecutionPlan(backend="mesh", mesh=...))``.  This module keeps the
reference's APC-specialized surface: ``ShardedAPC`` (one iteration and a
residual monitor over raw (A, chol, x, xbar) shards), ``prepare_on_mesh``
and the ``solve_on_mesh`` one-call driver, every one delegating to the
APC hooks (``solvers/projection.py``), so the iteration maths lives in
one place.  The reference's functions take arrays sharded over the mesh;
these take THIS rank's shards, as ``prepare_on_mesh`` returns them.

Imports of ``repro_torch.solvers`` are deferred into the functions, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .partition import BlockSystem


@dataclasses.dataclass(frozen=True)
class ShardedAPC:
    """Distributed APC bound to a mesh."""
    mesh: object
    worker_axes: Tuple[str, ...]   # axes the m workers shard over
    model_axis: Optional[str]      # axis the n dimension shards over
    gamma: float
    eta: float

    # ----- backend plumbing ----------------------------------------------
    def _ctx(self):
        from repro_torch.solvers.mesh import MeshContext
        return MeshContext(mesh=self.mesh, worker_axes=self.worker_axes,
                           model_axis=self.model_axis)

    def _solver(self):
        from repro_torch import solvers
        return solvers.get("apc")

    def _params(self):
        return {"gamma": self.gamma, "eta": self.eta}

    # ----- placements -----------------------------------------------------
    def specs(self):
        """Each operand's placement (``solvers.mesh``'s tuples: ``"w"``
        the workers' axis, ``"n"`` the columns')."""
        return {"A": ("w", None, "n"), "b": ("w", None),
                "chol": ("w", None, None), "x": ("w", "n"), "xbar": ("n",)}

    # ----- one APC iteration over raw shards ------------------------------
    def step_fn(self):
        """(A, chol, x, xbar) -> (x, xbar): one Eq. 2a/2b iteration on
        this rank's shards."""
        from repro_torch.core.apc import APCState
        from repro_torch.solvers.projection import ProjFactors
        ctx, solver, prm = self._ctx(), self._solver(), self._params()

        def step(A, chol, x, xbar):
            st = solver.mesh_step(ProjFactors(A=A, chol=chol), None,
                                  APCState(x=x, xbar=xbar, t=0), prm, ctx)
            return st.x, st.xbar

        return step

    # ----- residual (convergence monitoring) ------------------------------
    def residual_fn(self):
        """(A, b, xbar) -> ‖A x̄ − b‖/‖b‖ from this rank's shards."""
        import torch

        from repro_torch.solvers.mesh import residual_shard
        ctx = self._ctx()

        def residual(A, b, xbar):
            b_norm = torch.sqrt(ctx.psum_workers(torch.sum(b * b)))
            return residual_shard(A, b, xbar, b_norm, ctx)

        return residual


def make_sharded_apc(mesh, *, worker_axes: Sequence[str] = ("data",),
                     model_axis: Optional[str] = "model",
                     gamma: float, eta: float) -> ShardedAPC:
    """A ``ShardedAPC`` with the axes the mesh lacks dropped."""
    names = tuple(mesh.mesh_dim_names)
    if model_axis is not None and model_axis not in names:
        model_axis = None
    worker_axes = tuple(a for a in worker_axes if a in names)
    return ShardedAPC(mesh=mesh, worker_axes=worker_axes,
                      model_axis=model_axis, gamma=gamma, eta=eta)


def prepare_on_mesh(solver: ShardedAPC, sys: BlockSystem):
    """This rank's (A, b, chol, x0, xbar0) shards: A and b copied shard by
    shard, the Gram Cholesky and the initial state computed on the mesh,
    so no rank holds the whole A."""
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.solvers.mesh import _shard
    ctx, apc, prm = solver._ctx(), solver._solver(), solver._params()
    sp, device = solver.specs(), mesh_device(solver.mesh)
    A = _shard(sys.A_blocks, sp["A"], ctx, device)
    b = _shard(sys.b_blocks, sp["b"], ctx, device)
    factors = apc.mesh_prepare(A, prm, ctx)  # repro: allow[R003]
    st = apc.mesh_init(factors, b, prm, ctx)
    return A, b, factors.chol, st.x, st.xbar


def solve_on_mesh(mesh, sys: BlockSystem, *, iters: int = 500,
                  gamma: Optional[float] = None, eta: Optional[float] = None,
                  worker_axes: Sequence[str] = ("data",),
                  model_axis: Optional[str] = "model"):
    """End-to-end distributed APC (the legacy surface): (x̄, the final
    residual).  New code calls the backend for the whole ``SolveResult``:
    ``solvers.get(name).solve(sys, plan=ExecutionPlan(backend="mesh",
    mesh=mesh))``."""
    from repro_torch import solvers
    from repro_torch.solvers.mesh import solve_mesh
    res = solve_mesh(solvers.get("apc"), sys, mesh=mesh, iters=iters,
                     worker_axes=worker_axes, model_axis=model_axis,
                     gamma=gamma, eta=eta)
    return res.x, float(res.residuals[-1])
