"""R003 suppressed inline, with its reason."""


def timed_prepare(solver, A, prm):
    # the factorization's own time is what is measured here
    return solver.prepare(A, prm)  # repro: allow[R003]
