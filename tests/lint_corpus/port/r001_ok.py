"""R001 conforming: built once at module scope."""
import torch

compiled_abs = torch.compile(abs)


def run(x):
    return compiled_abs(x)
