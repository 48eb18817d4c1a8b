"""Straggler smoke of the port: apc r=2 under a rotating straggler is
EXACT (equal to the no-failure run) on the local backend and on a 2 x 1
mesh of two gloo ranks the script spawns (twin of
scripts/smokes/straggler.py, whose mesh is 2 x 2 on four forced host
devices).

    python scripts/smokes_torch/straggler.py [--device cpu]
"""
import time

import _common

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys


def _sched(t):
    return np.array([i != (t % 4) for i in range(4)])


def _check(device, plan_kw, tag):
    sys_ = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=3,
                                       device=device)
    s = solvers.get("apc")
    prm = s.resolve_params(sys_)
    r0 = s.solve(sys_, iters=120, **prm)                       # no failures
    r = s.solve(sys_, iters=120, plan=solvers.ExecutionPlan(
        redundancy=2, alive_schedule=_sched, **plan_kw), **prm)
    assert np.allclose(r.residuals.cpu().numpy(), r0.residuals.cpu().numpy(),
                       rtol=1e-6, atol=1e-12), tag
    assert np.allclose(r.x.cpu().numpy(), r0.x.cpu().numpy(),
                       rtol=1e-8, atol=1e-10), tag


def rank_main(args):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    device = dev.resolve(args.device)
    _common.join(args)
    try:
        mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), device=device)
        _check(device, dict(backend="mesh", mesh=mesh), "mesh")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = _common.parse(__doc__, argv)
    if args.rank is not None:
        return rank_main(args)
    device = dev.resolve(args.device)
    t0 = time.time()
    _check(device, {}, "local")
    _common.spawn(__file__, args.device, world=2)
    print(f"straggler smoke OK: apc r=2 exact under a rotating straggler "
          f"on local and a 2 x 1 mesh of two gloo ranks, {device} in "
          f"{time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
