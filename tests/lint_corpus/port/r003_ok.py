"""R003 conforming: through the store, or a solver's own prepare."""


def serve(store, solver, sys_, prm):
    return store.factors(solver, sys_, **prm)


class Solver:
    def prepare(self, A, prm):
        return A

    def refresh(self, A, prm):
        return self.prepare(A, prm)
