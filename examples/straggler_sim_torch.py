"""Fault-tolerance demo on the port's solver API (twin of
examples/straggler_sim.py): redundant execution
(``solve(sys, plan=ExecutionPlan(redundancy=r, alive_schedule=...))``)
keeps converging while workers randomly stall, and the run matches the
no-failure run exactly.  Also shows a ``runtime.fault.HeartbeatMonitor``
as the alive-mask source: its ``drop_set()`` (dead OR straggling
workers) is read when the schedule is lowered at launch.

    PYTHONPATH=src python examples/straggler_sim_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys
from repro_torch.runtime import fault


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    device = dev.resolve(ap.parse_args(argv).device)
    m, r = 8, 2
    sys_ = linsys.conditioned_gaussian(n=128, m=m, cond=20.0, seed=3,
                                       device=device)
    rng = np.random.default_rng(0)

    def alive_schedule(t):
        """One random straggler every iteration (but never an uncovered
        pattern — the monitor would trigger a re-partition otherwise)."""
        a = np.ones(m, bool)
        a[rng.integers(0, m)] = False
        assert fault.covering_ok(a, r)
        return a

    apc = solvers.get("apc")
    clean = apc.solve(sys_, iters=300)
    failing = apc.solve(sys_, iters=300,
                        plan=solvers.ExecutionPlan(
                            redundancy=r, alive_schedule=alive_schedule))
    deviation = float((clean.x - failing.x).abs().max())
    print(f"no-failure final residual:   {clean.residuals[-1]:.3e}")
    print(f"with-straggler residual:     {failing.residuals[-1]:.3e}")
    print(f"iterate deviation:           {deviation:.3e}")
    print("straggler mitigation is EXACT (solvers/redundant.py invariant)")

    # live alive-masks from the heartbeat runtime: worker 5 goes silent,
    # worker 2 is 5x slower than the median -> both land in drop_set()
    mon = fault.HeartbeatMonitor(n_workers=m, timeout=60.0,
                                 straggler_factor=3.0)
    now = time.monotonic()
    for w in range(m):
        mon.beat(w, now=now, duration=5.0 if w == 2 else 1.0)
    mon.mark_dead(5)
    dropped = [int(w) for w in np.flatnonzero(mon.drop_set())]
    monitored = apc.solve(sys_, iters=300,
                          plan=solvers.ExecutionPlan(redundancy=r,
                                                     alive_schedule=mon))
    dev_m = float((clean.x - monitored.x).abs().max())
    print(f"monitor drops workers {dropped}; residual "
          f"{monitored.residuals[-1]:.3e}  deviation {dev_m:.3e}")


if __name__ == "__main__":
    main()
