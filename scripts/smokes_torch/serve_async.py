"""Async-serving smoke of the port: AsyncLinsysServer pipelines a
2-system open-loop request stream — every residual under tol, zero sheds
at a feasible rate, zero steady-state builds or captures (attributed by
tracecheck: a failure names the call site), and the SLO report populated
(twin of scripts/smokes/serve_async.py).

    python scripts/smokes_torch/serve_async.py [--device cpu]
"""
import time

import _common

import numpy as np

from repro_torch import device as dev
from repro_torch.analysis import tracecheck
from repro_torch.data import linsys
from repro_torch.solvers import AsyncLinsysServer, FactorStore, Shed


def main(argv=None):
    args = _common.parse(__doc__, argv)
    device = dev.resolve(args.device)
    t0 = time.time()
    N_REQ = 12
    s1 = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=0,
                                     device=device)
    s2 = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=1,
                                     device=device)
    store = FactorStore()
    srv = AsyncLinsysServer(store, solver="apc", iters=600, tol=1e-6,
                            batch=2, pipeline_depth=2, admit_capacity=64)
    fps = [srv.register(s1), srv.register(s2)]
    rng = np.random.default_rng(0)

    with srv:
        # prime off the clock: the first batch per system prepares and
        # builds its program
        prime = [srv.submit(fps[i % 2], rng.standard_normal(64))
                 for i in range(4)]
        for t in prime:
            t.result(timeout=300)
        srv.reset_metrics()

        # steady state under tracecheck: a build or capture anywhere in
        # the pipeline fails here NAMING the offending call site
        with tracecheck(steady_state=True):
            tickets = [srv.submit(fps[i % 2], rng.standard_normal(64))
                       for i in range(N_REQ)]
            results = [t.result(timeout=300) for t in tickets]
        cache1 = srv.jit_cache_size()

    assert [r.rid for r in results] == [t.rid for t in tickets]
    sheds = [r for r in results if isinstance(r, Shed)]
    assert not sheds, f"unexpected sheds at a feasible rate: {sheds}"
    bad = [r.residual for r in results if not r.residual < 1e-6]
    assert not bad, f"residuals above tol: {bad}"
    rep = srv.latency_report()
    assert rep["count"] == N_REQ and rep["p99_ms"] > 0
    assert srv.stats.served == N_REQ and srv.stats.shed == 0
    print(f"serve_async smoke OK: {N_REQ} requests over 2 systems on "
          f"{device}, p50/p99 {rep['p50_ms']:.0f}/{rep['p99_ms']:.0f} ms, "
          f"{srv.stats.batches} batches, program cache {cache1}, "
          f"store {store.stats} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
