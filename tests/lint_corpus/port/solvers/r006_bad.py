"""R006 violations: a second device selector, and silent fallbacks."""
import torch

from repro_torch.kernels import ops
from repro_torch.solvers import executor


def where():
    return "cuda" if torch.cuda.is_available() else "cpu"     # R006


def gather(A, X, Xb):
    try:
        return ops.proj_gather(A, X, Xb)
    except RuntimeError:
        return ops.apc_gather_ref(A, X, Xb)                   # R006


def history(h, state, iters):
    try:
        return executor.run_history(h, state, iters)
    except RuntimeError:
        return executor.eager_history(h, state, iters)        # R006
