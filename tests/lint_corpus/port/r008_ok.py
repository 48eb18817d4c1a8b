"""R008 conforming: the hooks, and the blockops import."""
from repro_torch.core import blockops


class LsSolver:
    supports = frozenset({"square", "least_squares", "sparse"})

    def ls_moment(self, factors, A, b, x, params):
        return blockops.bmatvec(A, x) - b

    def ls_reference(self, sys_):
        return sys_.x_true
