"""R008 violations: modes declared without their hooks or blockops."""


class LsClaim:                                 # R008: no ls hooks
    supports = frozenset({"square", "least_squares"})

    def ls_moment(self, *a):
        raise NotImplementedError


class SparseClaim:                             # R008: no blockops import
    supports = frozenset({"square", "sparse"})
