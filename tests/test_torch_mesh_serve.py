"""The port's mesh serving (``LinsysServer``/``AsyncLinsysServer`` with
``backend="mesh"``) in-process, on a one-rank gloo group.

Twins of tests/test_linsys_server.py's ``test_mesh_server_matches_local``
and tests/test_pipeline_server.py's ``test_async_mesh_matches_local``:
the port's mesh servers against the REFERENCE's local servers on the same
traffic (the reference's own mesh cannot run on JAX 0.9.0, ROADMAP C0) —
x to rtol 1e-8 / atol 1e-10, the residual to 1e-6 relative — plus the
kernel path (the port's plain versions here), warm starts, the mesh key,
and the refusals of the SPMD admission: a follower never admits, and a
one-rank group needs none.  tests/test_torch_mesh_ranks.py serves at
world 2 with a follower rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro.data import linsys as ref_linsys  # noqa: E402
from repro.solvers.pipeline import \
    AsyncLinsysServer as RefAsync  # noqa: E402
from repro.solvers.serve import LinsysServer as RefServer  # noqa: E402
from repro.solvers.store import FactorStore as RefStore  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.solvers.pipeline import AsyncLinsysServer  # noqa: E402
from repro_torch.solvers.serve import LinsysServer  # noqa: E402
from repro_torch.solvers.store import FactorStore  # noqa: E402

torch.set_num_threads(1)

PRM = {"gamma": 1.0, "eta": 1.0}
SYS = dict(n=48, m=4, cond=10.0, seed=0)
X_TOL = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A one-rank gloo group from a FileStore, for this module alone."""
    if dist.is_initialized():
        dist.destroy_process_group()
    store = dist.FileStore(str(tmp_path_factory.mktemp("group") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def systems():
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


def _close(port, ref):
    assert [r.rid for r in port] == [r.rid for r in ref]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.x, np.asarray(r.x), **X_TOL)
        assert p.residual == pytest.approx(r.residual, rel=1e-6)
        assert p.iters_to_tol == r.iters_to_tol and p.warm == r.warm


def _sync(cls, store_cls, sys_, B, **kw):
    srv = cls(store_cls(), solver="apc", iters=80, batch=2, **PRM, **kw)
    fp = srv.register(sys_)
    for b in B:
        srv.submit(fp, b)
    return srv, srv.drain()


def _async(cls, store_cls, sys_, rhs, **kw):
    srv = cls(store_cls(), solver="apc", iters=60, batch=2, **PRM, **kw)
    fp = srv.register(sys_)
    for b in rhs:
        srv.submit(fp, b)
    out = srv.drain()
    srv.close()
    return srv, out


@pytest.mark.parametrize("kernel", [False, True])
def test_mesh_server_matches_local(systems, kernel):
    """The sync server on backend="mesh" against the reference's local
    server (test_linsys_server.py:302), unfused and on the kernels."""
    ref_sys, sys_ = systems
    B = np.random.default_rng(7).standard_normal((3, ref_sys.N))
    _, ref = _sync(RefServer, RefStore, ref_sys, B, use_kernel=kernel)
    srv, out = _sync(LinsysServer, FactorStore, sys_, B, backend="mesh",
                     use_kernel=kernel)
    _close(out, ref)
    assert (srv.stats.batches, srv.stats.padded) == (2, 1)
    (ex,) = srv._executors.values()
    assert type(ex).__name__ == "_MeshExecutor"
    assert srv.jit_cache_size() == 1


@pytest.mark.parametrize("kernel", [False, True])
def test_async_mesh_matches_local(systems, kernel):
    """The async server on backend="mesh" (its assembly thread runs each
    batch itself) against the reference's local async server
    (test_pipeline_server.py:257)."""
    ref_sys, sys_ = systems
    rng = np.random.default_rng(8)
    rhs = [rng.standard_normal(ref_sys.N) for _ in range(4)]
    _, ref = _async(RefAsync, RefStore, ref_sys, rhs, use_kernel=kernel)
    srv, out = _async(AsyncLinsysServer, FactorStore, sys_, rhs,
                      backend="mesh", use_kernel=kernel)
    _close(out, ref)
    assert (srv.stats.served, srv.stats.shed) == (4, 0)


def test_mesh_warm_start_matches_local(systems):
    """Warm starts across batches (repeated right-hand sides): the
    states come back global and go back in sharded."""
    ref_sys, sys_ = systems
    B = np.random.default_rng(9).standard_normal((2, ref_sys.N))
    B = np.concatenate([B, B, B])
    _, ref = _sync(RefServer, RefStore, ref_sys, B, warm_start=True)
    srv, out = _sync(LinsysServer, FactorStore, sys_, B, backend="mesh",
                     warm_start=True)
    _close(out, ref)
    assert srv.stats.warm_batches == 2


def test_mesh_server_on_a_plan_with_a_mesh(systems):
    """``plan=ExecutionPlan(backend="mesh", mesh=...)``: the executor key
    keeps the mesh's shape and axes; a sparse system serves on the sparse
    kernels (model axis off)."""
    ref_sys, sys_ = systems
    mesh = mesh_lib.solver_mesh(1, 1, device="cpu")
    plan = solvers.ExecutionPlan(backend="mesh", mesh=mesh, kernel=True)
    srv = LinsysServer(FactorStore(), solver="apc", iters=40, batch=2,
                       plan=plan, **PRM)
    fp = srv.register(sys_)
    key = srv._systems[fp].executor_key
    assert key[-1] == ((1, 1), ("data", "model"))
    assert key[-4][0] == "mesh"
    sp = linsys.banded_system(n=64, m=4, bandwidth=4, seed=0, device="cpu")
    sfp = srv.register(sp)
    B = np.random.default_rng(3).standard_normal((2, sp.N))
    for b in B:
        srv.submit(sfp, b)
    out = srv.drain(final=True)
    ref = solvers.get("apc").solve_many(
        sp, B, iters=40, plan=solvers.ExecutionPlan(kernel=True), **PRM)
    for r, x in zip(out, ref.x):
        np.testing.assert_allclose(r.x, x.numpy(), **X_TOL)


def test_one_rank_needs_no_follower():
    """On a one-rank group rank 0 is the whole mesh: no follower to run,
    close() sends nothing, and the reference's API works unchanged."""
    srv = LinsysServer(FactorStore(), backend="mesh")
    assert not srv._follows() and not srv._leads()
    with pytest.raises(RuntimeError, match="serve_follower"):
        srv.serve_follower()
    srv.close()
    assert srv.drain() == []
    local = LinsysServer(FactorStore())
    with pytest.raises(RuntimeError, match="serve_follower"):
        local.serve_follower()
