"""R009 violation: internal code on the deprecated loose kwargs."""


def run(solver, sys_):
    return solver.solve(sys_, use_kernel=True, backend="mesh")   # R009
