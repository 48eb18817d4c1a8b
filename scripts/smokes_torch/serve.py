"""Serving smoke of the port: LinsysServer drains a 2-system request
stream with factor-store amortization (>= N-2 hits) and every residual
under tol (twin of scripts/smokes/serve.py).

    python scripts/smokes_torch/serve.py [--device cpu]
"""
import time

import _common

import numpy as np

from repro_torch import device as dev
from repro_torch.data import linsys
from repro_torch.solvers import FactorStore, LinsysServer


def main(argv=None):
    args = _common.parse(__doc__, argv)
    device = dev.resolve(args.device)
    t0 = time.time()
    N_REQ = 8
    s1 = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=0,
                                     device=device)
    s2 = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=1,
                                     device=device)
    store = FactorStore()
    # batch=1: every request is its own store lookup, so exactly the first
    # request per system may miss
    srv = LinsysServer(store, solver="apc", iters=600, tol=1e-6, batch=1)
    fps = [srv.register(s1), srv.register(s2)]
    rng = np.random.default_rng(0)
    for i in range(N_REQ):
        srv.submit(fps[i % 2], rng.standard_normal(64))
    out = srv.drain()
    assert len(out) == N_REQ and [r.rid for r in out] == list(range(N_REQ))
    bad = [r.residual for r in out if not r.residual < 1e-6]
    assert not bad, f"residuals above tol: {bad}"
    assert store.stats.total_hits >= N_REQ - 2, store.stats
    assert srv.stats.served == N_REQ and srv.stats.padded == 0
    print(f"serve smoke OK: {N_REQ} requests over 2 systems on {device}, "
          f"store {store.stats}, {srv.stats.executor_builds} executor "
          f"build(s) in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
