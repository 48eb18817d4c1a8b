"""Elastic smoke of the port: ElasticRuntime survives kill -> rejoin ->
taskmaster loss: the death re-lowers the schedule exactly (oracle-equal
history), the recovery rebuilds every block factor from the store's disk
tier (counted as reuse), and the solve still converges below tol (twin
of scripts/smokes/elastic.py).

    python scripts/smokes_torch/elastic.py [--device cpu]
"""
import tempfile
import time

import _common

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.solvers import ExecutionPlan, FactorStore

TOL = 1e-8


def main(argv=None):
    args = _common.parse(__doc__, argv)
    device = dev.resolve(args.device)
    t0 = time.time()
    sys_ = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=3,
                                       device=device)
    s = solvers.get("apc")
    prm = s.resolve_params(sys_)
    oracle = s.solve(sys_, iters=150, tol=TOL, plan=ExecutionPlan(), **prm)

    with tempfile.TemporaryDirectory() as tmp:
        store_dir, ck_dir = tmp + "/store", tmp + "/ck"
        mon = HeartbeatMonitor(n_workers=sys_.m)
        rt = solvers.ElasticRuntime(
            s, sys_,
            plan=ExecutionPlan(redundancy=2,
                               store=FactorStore(directory=store_dir)),
            monitor=mon, segment=25, tol=TOL, checkpoint_dir=ck_dir, **prm)
        r1 = rt.run(iters=50)
        mon.mark_dead(2)                       # kill mid-solve
        r2 = rt.run(iters=25)
        mon.rejoin(2, resynced=True)           # returnee: pure reassignment
        r3 = rt.run(iters=25)
        assert r3.relowerings == 1 and r3.repartitions == 0, \
            (r3.relowerings, r3.repartitions)
        res = np.concatenate([r.residuals.cpu().numpy()
                              for r in (r1, r2, r3)])
        assert np.allclose(res, oracle.residuals.cpu().numpy()[:100],
                           rtol=1e-6, atol=1e-12)
        del rt                                 # the taskmaster dies

        rt2 = solvers.ElasticRuntime.recover(
            s, sys_, ck_dir,
            plan=ExecutionPlan(redundancy=2,
                               store=FactorStore(directory=store_dir)),
            monitor=HeartbeatMonitor(n_workers=sys_.m), **prm)
        assert rt2.reused_blocks >= 1, rt2.reused_blocks
        assert rt2.reused_blocks == sys_.m and rt2.prepared_blocks == 0
        rep = rt2.run(iters=50)
        assert rep.iters == 150
        assert float(rep.residuals[-1]) < TOL, float(rep.residuals[-1])
        np.testing.assert_allclose(rep.x.cpu().numpy(),
                                   oracle.x.cpu().numpy(),
                                   rtol=1e-6, atol=1e-10)
    print(f"elastic smoke OK: death re-lowered exactly, recovery reused "
          f"{rt2.reused_blocks}/{sys_.m} block factors from disk, final "
          f"residual {float(rep.residuals[-1]):.1e} < {TOL} on {device} in "
          f"{time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
