"""R001 violations: a CUDA graph built per call, a compile in a
module-level loop."""
import torch


def step_graph(fn):
    g = torch.cuda.CUDAGraph()             # R001: per call
    with torch.cuda.graph(g):
        fn()
    return g


for f in (abs, len):
    compiled = torch.compile(f)            # R001: module-level loop
