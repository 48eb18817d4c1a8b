"""R005 violations: core/ importing solvers/ and kernels/ at module
scope."""
from repro_torch.solvers import api            # R005
import repro_torch.kernels.ops                 # R005
from ..solvers import executor                 # R005

__all__ = ["api", "executor", "repro_torch"]
