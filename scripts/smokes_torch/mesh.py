"""Mesh-backend smoke of the port: every registered solver sharded on two
gloo ranks, meshes 1 x 2 and 2 x 1 (data x model), matches the local
backend (twin of scripts/smokes/mesh.py, whose mesh is 2 x 2 on four
forced host devices).  The script spawns its own two ranks.

    python scripts/smokes_torch/mesh.py [--device cpu]
"""
import time

import _common

import numpy as np

from repro_torch import device as dev

SHAPES = ((1, 2), (2, 1))


def rank_main(args):
    import torch.distributed as dist

    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    device = dev.resolve(args.device)
    _common.join(args)
    try:
        sys_ = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=3,
                                           device=device)
        local = {}
        for name in solvers.available():
            s = solvers.get(name)
            prm = s.resolve_params(sys_)
            local[name] = prm, s.solve(sys_, iters=120, **prm)
        for shape in SHAPES:
            mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                                      device=device)
            for name in solvers.available():
                s = solvers.get(name)
                prm, rl = local[name]
                rm = s.solve(sys_, iters=120,
                             plan=solvers.ExecutionPlan(backend="mesh",
                                                        mesh=mesh), **prm)
                assert np.allclose(rm.residuals.cpu().numpy(),
                                   rl.residuals.cpu().numpy(),
                                   rtol=1e-6, atol=1e-12), (shape, name)
                assert rm.errors is not None, (shape, name)
                assert tuple(rm.residuals.shape) == (120,), (shape, name)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = _common.parse(__doc__, argv)
    if args.rank is not None:
        return rank_main(args)
    dev.resolve(args.device)
    t0 = time.time()
    _common.spawn(__file__, args.device, world=2)
    from repro_torch import solvers
    print(f"mesh smoke OK: {solvers.available()} sharded on two gloo "
          f"ranks, meshes {SHAPES} (data, model), {args.device} in "
          f"{time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
