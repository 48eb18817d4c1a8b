"""R002 violations: host clock, RNG and syncs in captured regions."""
import time

import numpy as np
import torch

from repro_torch.solvers import executor


def graph_body(g, x):
    with torch.cuda.graph(g):  # repro: allow[R001] R002's corpus
        y = x * 2
        scale = y.sum().item()             # R002: host sync
        z = y * time.time()                # R002: host clock
    return z, scale


def raw_capture(g, x):
    g.capture_begin()
    noise = torch.randn(3)                 # R002: no generator=
    g.capture_end()
    return noise


def scan_step(factors, b, state):
    print(state.x.cpu())                   # R002: host sync
    return state


def history(factors, b, A):
    return executor.History(scan_step, lambda s: s, factors, b, A)


def captured_lambda():
    # R002 below; the per-call capture is R001's corpus
    return executor._capture(lambda: np.random.rand(3),  # repro: allow[R001]
                             "noise")
