"""R009 suppressed inline, with its reason."""


def legacy(solver, sys_):
    # the shim's own test of its DeprecationWarning
    return solver.solve(sys_, use_kernel=True)  # repro: allow[R009]
