"""R006 conforming: the caller's device, and failures that raise."""
from repro_torch import device as dev
from repro_torch.kernels import ops


def where(device=None):
    return dev.resolve(device)


def gather(A, X, Xb):
    try:
        return ops.proj_gather(A, X, Xb)
    except RuntimeError as e:
        raise RuntimeError(f"the gather failed on {A.device}") from e
