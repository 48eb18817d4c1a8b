"""R001 suppressed inline, with its reason."""
import torch


def probe(fn):
    # a one-off probe: captured once and thrown away
    g = torch.cuda.CUDAGraph()  # repro: allow[R001]
    return g
