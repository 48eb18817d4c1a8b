"""R002 conforming: host work hoisted out of the captured regions."""
import time

import numpy as np
import torch

from repro_torch.solvers import executor


def graph_body(g, x, gen):
    t = time.time()
    scale = x.sum().item()
    with torch.cuda.graph(g):  # repro: allow[R001] R002's corpus
        noise = torch.randn(3, generator=gen)
        y = x * 2 + noise
    return y, scale, t


def scan_step(factors, b, state):
    return state


def history(factors, b, A):
    rng = np.random.default_rng(0)
    return executor.History(scan_step, lambda s: s, factors, b, A), rng
