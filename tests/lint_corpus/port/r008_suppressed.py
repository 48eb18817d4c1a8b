"""R008 suppressed inline, with its reason."""


class Declared:  # repro: allow[R008] a capability table's fixture
    supports = frozenset({"sparse"})
