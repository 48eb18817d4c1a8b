"""System-mode scenarios smoke of the port: the three system classes —
dense square, least-squares and block-sparse — end to end through the
unified API on both backends (the mesh on two gloo ranks the script
spawns), plus the streaming mode: solve_stream drives 100 perturbed-b
requests through the sync and async servers with no steady-state build
or capture and warm hits on every warm_rhs_ok batch after the first
(twin of scripts/smokes/scenarios.py).

    python scripts/smokes_torch/scenarios.py [--device cpu]
"""
import time

import _common

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys
from repro_torch.solvers import (AsyncLinsysServer, CapabilityError,
                                 FactorStore, LinsysServer, solve_stream)

N_REQ = 100


def _np(t):
    return t.cpu().numpy()


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _sparse(device):
    return linsys.banded_system(n=256, m=4, bandwidth=8, seed=0,
                                device=device)


def _ls(device):
    return linsys.tall_gaussian(N=320, n=160, m=4, seed=0, noise=0.05,
                                device=device)


def sparse_scenario(device):
    sys_ = _sparse(device)
    assert sys_.is_sparse and sys_.sparsity > 0.8
    for name in ("apc", "cimmino", "dgd"):
        s = solvers.get(name)
        prm = s.resolve_params(sys_)
        r_sp = s.solve(sys_, iters=150, **prm)
        r_dn = s.solve(sys_.densified(), iters=150, **prm)
        assert np.allclose(_np(r_sp.residuals), _np(r_dn.residuals),
                           rtol=1e-6, atol=1e-12), name
    try:
        solvers.get("pdhbm").solve(sys_, iters=5)
    except CapabilityError:
        pass
    else:
        raise AssertionError("pdhbm accepted a sparse system")
    return f"sparse OK ({sys_.sparsity:.0%} zero, sparse ≡ densified)"


def ls_scenario(device):
    sys_ = _ls(device)
    assert sys_.mode == "least_squares"
    A, b = (_np(t) for t in sys_.dense())
    x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
    for name in ("dgd", "dhbm"):
        s = solvers.get(name)
        r = s.solve(sys_, iters=800, **s.resolve_params(sys_))
        assert _rel(_np(r.x), x_ls) < 1e-6, name
        assert r.residuals[-1] < 1e-8, name
    # Cimmino's Gram-weighted fixed point, against its own reference
    s = solvers.get("cimmino")
    r = s.solve(sys_, iters=800, **s.resolve_params(sys_))
    assert _rel(_np(r.x), _np(s.ls_reference(sys_))) < 1e-6
    try:
        solvers.get("apc").solve(sys_, iters=5)
    except CapabilityError:
        pass
    else:
        raise AssertionError("apc accepted a least-squares system")
    return "least-squares OK (lstsq parity)"


def stream_scenario(device):
    sys_ = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=0,
                                       device=device)
    rng = np.random.default_rng(0)
    b0 = rng.standard_normal(64)
    msgs = []
    for tag, srv in (
        ("sync", LinsysServer(FactorStore(), solver="dhbm", iters=150,
                              batch=1, warm_start=True)),
        ("async", AsyncLinsysServer(FactorStore(), solver="dhbm",
                                    iters=150, batch=1, warm_start=True)),
    ):
        fp = srv.register(sys_)
        stream = [(fp, b0 + 1e-3 * rng.standard_normal(64))
                  for _ in range(N_REQ)]
        # prime the cold AND warm executor paths (one batch each), then
        # the steady state's program cache must not grow
        solve_stream(srv, stream[:2])
        cache0 = srv.jit_cache_size()
        rep = solve_stream(srv, stream[2:])
        if hasattr(srv, "close"):
            srv.close()
        assert len(rep.served) == N_REQ - 2, tag
        assert rep.warm_batches == rep.batches, tag   # every batch warm
        assert all(r.warm for r in rep.served), tag
        assert all(r.residual < 1e-8 for r in rep.served), tag
        cache1 = srv.jit_cache_size()
        assert cache0 < 0 or cache1 == cache0, \
            f"{tag}: a steady-state build, program cache {cache0} -> {cache1}"
        msgs.append(f"{tag} warm rate {rep.warm_hit_rate:.0%}")
    return f"stream OK ({N_REQ} perturbed-b requests, " + ", ".join(msgs) + ")"


def rank_main(args):
    """The mesh half on each rank: the sparse system on a 2 x 1 mesh (a
    sparse mesh has no model axis), the least-squares one on 1 x 2, each
    held to the local run."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    device = dev.resolve(args.device)
    _common.join(args)
    try:
        sp = _sparse(device)
        mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), device=device)
        for name in ("apc", "cimmino", "dgd"):
            s = solvers.get(name)
            prm = s.resolve_params(sp)
            r_sp = s.solve(sp, iters=150, **prm)
            r_mesh = s.solve(sp, iters=150, plan=solvers.ExecutionPlan(
                backend="mesh", mesh=mesh), **prm)
            assert np.allclose(_np(r_mesh.x), _np(r_sp.x), rtol=1e-8,
                               atol=1e-10), name
        ls = _ls(device)
        A, b = (_np(t) for t in ls.dense())
        x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
        mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device=device)
        for name in ("dgd", "dhbm"):
            s = solvers.get(name)
            r = s.solve(ls, iters=800, plan=solvers.ExecutionPlan(
                backend="mesh", mesh=mesh), **s.resolve_params(ls))
            assert _rel(_np(r.x), x_ls) < 1e-6, name
            assert r.residuals[-1] < 1e-8, name
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = _common.parse(__doc__, argv)
    if args.rank is not None:
        return rank_main(args)
    device = dev.resolve(args.device)
    t0 = time.time()
    lines = [sparse_scenario(device), ls_scenario(device),
             stream_scenario(device)]
    _common.spawn(__file__, args.device, world=2)
    lines.append("mesh OK (sparse 2 x 1, least-squares 1 x 2: two gloo "
                 "ranks, local parity)")
    for ln in lines:
        print("  " + ln)
    print(f"scenarios smoke OK on {device} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
