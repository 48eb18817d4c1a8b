"""R005 suppressed inline, with its reason."""
# a type the shim re-exports, cycle-free in this layout
from repro_torch.solvers import api  # repro: allow[R005]

__all__ = ["api"]
