"""Solver-registry smoke of the port: all eight methods resolve and
round-trip the unified lifecycle (twin of scripts/smokes/registry.py).

    python scripts/smokes_torch/registry.py [--device cpu]
"""
import time

import _common

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys


def main(argv=None):
    args = _common.parse(__doc__, argv)
    device = dev.resolve(args.device)
    t0 = time.time()
    sys_ = linsys.conditioned_gaussian(n=128, m=4, cond=20.0, seed=0,
                                       device=device)
    names = solvers.available()
    required = {"apc", "cimmino", "consensus", "dgd", "dhbm", "dnag",
                "madmm", "pdhbm"}
    missing = required - set(names)
    assert not missing, f"missing solvers: {missing}"
    for n in names:
        s = solvers.get(n)                       # registry lookup
        r = s.solve(sys_, iters=30)              # lifecycle round-trip
        assert r.name == n and tuple(r.x.shape) == (sys_.n,), n
        assert r.x.device.type == device.type, n
    print(f"registry smoke OK: {names} on {device} in "
          f"{time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
