"""Kernel smoke of the port: every kernel path of the projection engine,
and the engine verdict and k-chunk pins of ``kernels/ops.py`` (twin of
scripts/smokes/kernel.py).

Against the plain PyTorch versions (on the CPU the ops ARE the plain
versions; on the card each launch is held to its plain version):

  * raw ops — ``block_projection`` (single and multi-RHS), the split
    ``proj_gather``/``proj_scatter`` pair and the Cimmino pair, at a
    non-multiple-of-128 n and a p = 1 block;
  * sparse ops — ``sparse_proj_update``/``sparse_cimmino_update`` with
    the engine pinned fused, then end-to-end sparse dispatch (local and a
    one-rank mesh, history parity) and a ``precision="mixed"`` solve;
  * solver paths — apc / consensus / cimmino with ``kernel=True`` on the
    local and the mesh backend, and ``solve_many``;
  * serving — ``LinsysServer(use_kernel=True)`` batches with no build or
    capture after the first;
  * the ops layer — the unpinned engine verdicts (the heuristic here,
    measured on the card), ``REPRO_KERNEL_ENGINE`` pins, and each
    ``REPRO_KERNEL_BK`` k-chunk pin (1, 2, 4, 8; 16 refused), the pinned
    ``solve_many`` histories bit-equal across pins; the BN cache fills
    and ``REPRO_KERNEL_BN`` pins.

    python scripts/smokes_torch/kernel.py [--device cpu]
"""
import contextlib
import os
import time
import warnings

import _common

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.solvers import FactorStore, LinsysServer

PROJ = ("apc", "consensus", "cimmino")


@contextlib.contextmanager
def env(name, value):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _np(t):
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()


def _mk(p, n, k, dtype, device, seed=0):
    """One worker's (1, p, n) block, its pinv factor (1, n, p) and
    operands in the ops' layout."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n))
    # the launchers take contiguous matrix stacks, as the solvers keep them
    B = np.ascontiguousarray(np.linalg.solve(A @ A.T, A).T)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    x = rng.standard_normal((1, n) if k == 1 else (1, k, n))
    xb = rng.standard_normal((n,) if k == 1 else (k, n))
    b = rng.standard_normal((1, p) if k == 1 else (1, k, p))
    return t(A[None]), t(B[None]), t(x), t(xb), t(b)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def smoke_raw_ops(device):
    for p, n, k, dtype, tol in ((8, 256, 1, torch.float32, 1e-4),
                                (7, 130, 5, torch.float64, 1e-10),
                                (1, 128, 16, torch.float64, 1e-10)):
        A, B, x, xb, b = _mk(p, n, k, dtype, device)
        _close(ops.block_projection(A, B, x, xb, 1.2),
               ops.block_projection_ref(A, B, x, xb, 1.2), tol)
        u = ops.proj_gather(A, x, xb)
        _close(u, ops.apc_gather_ref(A, x, xb), tol)
        _close(ops.proj_scatter(B, x, xb, u, 0.8),
               ops.apc_scatter_ref(B, x, xb, u, 0.8), tol)
        _close(ops.cimmino_update(A, B, b, xb),
               ops.cimmino_update_ref(A, B, b, xb), tol * 10)
    assert len(ops.bn_cache()) > 0 or os.environ.get(ops.BN_ENV), \
        "BN cache never filled"


def smoke_solver_paths(device, mesh):
    sys_ = linsys.conditioned_gaussian(n=96, m=4, cond=10.0, seed=3,
                                       device=device)
    Bk = np.random.default_rng(4).standard_normal((5, sys_.N))
    for name in PROJ:
        s = solvers.get(name)
        prm = s.resolve_params(sys_)
        r0 = s.solve(sys_, iters=100, **prm)
        for tag, plan in (
                ("local", solvers.ExecutionPlan(kernel=True)),
                ("mesh", solvers.ExecutionPlan(kernel=True, backend="mesh",
                                               mesh=mesh))):
            rk = s.solve(sys_, iters=100, plan=plan, **prm)
            assert np.allclose(_np(rk.residuals), _np(r0.residuals),
                               rtol=1e-6, atol=1e-12), (name, tag)
        m0 = s.solve_many(sys_, Bk, iters=100, **prm)
        mk = s.solve_many(sys_, Bk, iters=100,
                          plan=solvers.ExecutionPlan(kernel=True), **prm)
        assert np.allclose(_np(mk.residuals), _np(m0.residuals),
                           rtol=1e-6, atol=1e-12), name


def smoke_sparse_paths(device, mesh):
    rng = np.random.default_rng(6)
    for p, w, n, k, dtype, tol in ((8, 128, 256, 1, torch.float32, 1e-4),
                                   (7, 61, 130, 5, torch.float64, 1e-10)):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        vals = t(rng.standard_normal((1, p, w)))
        cols = torch.as_tensor(rng.choice(n, size=w, replace=False)[None],
                               dtype=torch.int64, device=device)
        bvals = t(rng.standard_normal((1, w, p)))
        x = t(rng.standard_normal((1, n) if k == 1 else (1, k, n)))
        xb = t(rng.standard_normal((n,) if k == 1 else (k, n)))
        b = t(rng.standard_normal((1, p) if k == 1 else (1, k, p)))
        with env(ops.ENGINE_ENV, "fused"):
            y, u = ops.sparse_proj_update(vals, cols, bvals, x, xb, 0.9)
            yr, ur = ops.sparse_proj_update_ref(vals, cols, bvals, x, xb,
                                                0.9)
            _close(y, yr, tol)
            _close(u, ur, tol)
            r, uc = ops.sparse_cimmino_update(vals, cols, bvals, b, xb)
            rr, ucr = ops.sparse_cimmino_update_ref(vals, cols, bvals, b,
                                                    xb)
            _close(r, rr, tol)
            _close(uc, ucr, tol)

    sys_ = linsys.banded_system(n=192, m=4, bandwidth=6, seed=0,
                                device=device)
    for name in ("apc", "cimmino"):
        s = solvers.get(name)
        prm = s.resolve_params(sys_)
        r0 = s.solve(sys_, iters=80, **prm)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            rk = s.solve(sys_, iters=80,
                         plan=solvers.ExecutionPlan(kernel=True), **prm)
            rm = s.solve(sys_, iters=80,
                         plan=solvers.ExecutionPlan(kernel=True,
                                                    backend="mesh",
                                                    mesh=mesh), **prm)
        for tag, r in (("local", rk), ("mesh", rm)):
            assert np.allclose(_np(r.residuals), _np(r0.residuals),
                               rtol=1e-4, atol=2e-6), (name, tag)
        # mixed precision: bf16 matrices stay finite and track the
        # float64 history within the bf16 envelope
        rx = s.solve(sys_, iters=80,
                     plan=solvers.ExecutionPlan(kernel=True,
                                                precision="mixed"), **prm)
        res = _np(rx.residuals)
        assert np.all(np.isfinite(res)), name
        assert np.allclose(res, _np(r0.residuals), rtol=0.5, atol=5e-2), \
            (name, float(res[-1]))


def smoke_serving(device):
    sys_ = linsys.conditioned_gaussian(n=96, m=4, cond=10.0, seed=3,
                                       device=device)
    store = FactorStore()
    srv = LinsysServer(store, solver="apc", iters=300, batch=4,
                       use_kernel=True)
    fp = srv.register(sys_)
    rng = np.random.default_rng(0)
    sizes = []
    for _ in range(3):
        for _ in range(4):
            srv.submit(fp, rng.standard_normal(sys_.N))
        out = srv.step()
        assert all(r.residual < 1e-6 for r in out), [r.residual for r in out]
        sizes.append(srv.jit_cache_size())
    tail = sizes[1:]
    assert (-1 in tail) or len(set(tail)) == 1, sizes
    assert store.stats.misses == 1 and store.stats.hits >= 2, store.stats


def smoke_ops_layer(device):
    """The engine verdicts unpinned (the reference's heuristic where
    nothing is measured: fused but Cimmino below a batch of 8), the
    pins, and every k-chunk pin on a k = 8 solve_many."""
    ops.engine_cache_clear()
    dtype = torch.float64
    want = {("apc", 1): True, ("apc", 8): True, ("cimmino", 1): False,
            ("cimmino", 8): True}
    cuda = device.type == "cuda"
    verdicts = {}
    for (family, k), heuristic in want.items():
        for fam, w in ((family, None), (family + "_sparse", 24)):
            got = ops.use_fused(fam, 24, 96, k, dtype, w=w, device=device)
            assert isinstance(got, bool)
            if not cuda:         # the card measures its own verdict
                assert got == heuristic, (fam, k)
            verdicts[f"{fam} k={k}"] = got
    for pin, want_pin in (("fused", True), ("unfused", False)):
        with env(ops.ENGINE_ENV, pin):
            assert ops.use_fused("cimmino", 24, 96, 1, dtype) is want_pin
    with env(ops.ENGINE_ENV, "maybe"):
        try:
            ops.use_fused("apc", 24, 96)
        except ValueError:
            pass
        else:
            raise AssertionError("a bad engine pin was accepted")
    with env(ops.BN_ENV, "128"):
        assert ops.pick_bn(256) == 128
    with env(ops.BN_ENV, "96"):
        try:
            ops.pick_bn(256)
        except ValueError:
            pass
        else:
            raise AssertionError("a BN pin that divides nothing passed")

    sys_ = linsys.conditioned_gaussian(n=96, m=4, cond=10.0, seed=3,
                                       device=device)
    Bk = np.random.default_rng(5).standard_normal((8, sys_.N))
    s = solvers.get("apc")
    prm = s.resolve_params(sys_)
    runs = {}
    with env(ops.ENGINE_ENV, "fused"):
        for kc in (1, 2, 4, 8):
            with env(ops.BK_ENV, str(kc)):
                assert ops.pick_tiles(128, 24, 8, dtype)[2] == kc
                runs[kc] = s.solve_many(sys_, Bk, iters=60, plan=solvers
                                        .ExecutionPlan(kernel=True), **prm)
        with env(ops.BK_ENV, "16"):
            try:
                s.solve_many(sys_, Bk, iters=5, plan=solvers.ExecutionPlan(
                    kernel=True), **prm)
            except ValueError:
                pass
            else:
                raise AssertionError("a k-chunk pin of 16 was accepted")
    first = runs[1]
    for kc, r in runs.items():
        assert torch.equal(r.x, first.x), kc
        assert torch.equal(r.residuals, first.residuals), kc
    return verdicts


def main(argv=None):
    args = _common.parse(__doc__, argv)
    device = dev.resolve(args.device)
    t0 = time.time()
    mesh = mesh_lib.solver_mesh_for(4, device=device)   # one rank
    smoke_raw_ops(device)
    smoke_solver_paths(device, mesh)
    smoke_sparse_paths(device, mesh)
    smoke_serving(device)
    verdicts = smoke_ops_layer(device)
    dist.destroy_process_group()          # the one-rank mesh's group
    print(f"kernel smoke OK on {device} ("
          f"{'kernels vs plain versions' if device.type == 'cuda' else 'plain versions'}): "
          f"raw ops + sparse/mixed + 3 solvers x local/mesh/solve_many + "
          f"serving + engine verdicts {verdicts} + KC pins 1/2/4/8 "
          f"bit-equal, bn cache {ops.bn_cache()} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
