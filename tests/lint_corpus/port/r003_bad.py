"""R003 violation: a raw prepare outside the store."""


def serve(solver, sys_, prm):
    factors = solver.prepare(sys_.A_op, prm)     # R003
    return factors
