"""R009 conforming: the execution surface on the plan."""
from repro_torch.solvers.capability import ExecutionPlan


def run(solver, sys_):
    return solver.solve(sys_, plan=ExecutionPlan(kernel=True,
                                                 backend="mesh"))
