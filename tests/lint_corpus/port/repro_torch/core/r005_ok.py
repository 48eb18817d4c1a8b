"""R005 conforming: the shim imports lazily."""
from repro_torch.core import blockops


def solve(sys_):
    from repro_torch.solvers import registry
    return registry.get("apc").solve(sys_), blockops
