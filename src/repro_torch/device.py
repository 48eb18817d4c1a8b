"""The one device/dtype rule of the port.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.  A host without a CUDA device raises instead of
carrying on silently on the CPU: a CPU run is only ever one the caller
asked for.
"""
from __future__ import annotations

from typing import Union

import torch

#: The solver paths run float64 end to end (the paper's setting).
DEFAULT_DTYPE = torch.float64

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises ``RuntimeError`` when CUDA is wanted (explicitly or by default)
    and no CUDA device exists, and ``ValueError`` for device types the
    port does not run on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is not supported; expected 'cuda' "
                         f"or 'cpu'")
    return dev


def as_tensor(x, *, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as a tensor on the resolved device.

    A tensor passed without ``device=`` stays where it is; anything else
    (numpy arrays, lists) goes to :func:`resolve` ``(device)``, keeping
    its dtype.
    """
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve(device))
