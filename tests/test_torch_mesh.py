"""The port's mesh backend in-process, on a one-rank gloo group.

``backend="mesh"`` runs the whole backend path (placement, the on-mesh
prepare and init, the history loop, every ``all_reduce``) on a (1, 1)
mesh; tests/test_torch_mesh_ranks.py runs it at world 2 and 4.  The
reference's own mesh cannot run on JAX 0.9.0 (ROADMAP C0), so the port is
held against the reference's LOCAL backend with the contract of
tests/test_mesh_backend.py (x to rtol 1e-8 / atol 1e-10, histories to
rtol 1e-6 / atol 1e-12, ``iters_to_tol`` equal), on the cases of that
file, tests/test_modes.py's least-squares and sparse mesh cases, and the
kernel path (the port's plain versions here, the reference's Pallas
kernels in interpret mode, <= 1e-6 relative).  The per-shard maths is
held hook by hook against the reference's ``mesh_*`` hooks, called
directly with an identity context, within 1e-12 of max|ref| + 1.
"""
import contextlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.launch import solve as ref_cli  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import solve as cli  # noqa: E402
from repro_torch.solvers import mesh as mesh_backend  # noqa: E402
from repro_torch.solvers.capability import ExecutionPlan  # noqa: E402
from repro_torch.solvers.projection import ProjFactors  # noqa: E402

torch.set_num_threads(1)

ALL = ["apc", "cimmino", "consensus", "dgd", "dhbm", "dnag", "madmm",
       "pdhbm"]
PROJ = ["apc", "consensus", "cimmino"]
ITERS = 150
KITERS = 20            # the reference's interpret-mode kernels are slow
X_TOL = dict(rtol=1e-8, atol=1e-10)
H_TOL = dict(rtol=1e-6, atol=1e-12)
K_TOL = dict(rtol=1e-6, atol=1e-12)    # tests/test_kernel_engine.py _close
HOOK_TOL = 1e-12       # max|Δ| / (max|ref| + 1), float64
MIXED_ITERS = 40       # tests/test_torch_mixed.py ITERS
MIXED_HIST = dict(rtol=0, atol=1e-9)   # tests/test_torch_mixed.py HIST apc


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


def _pair(gen, **kw):
    return (getattr(ref_linsys, gen)(**kw),
            getattr(linsys, gen)(**kw, device="cpu"))


@pytest.fixture(scope="module")
def systems():
    return _pair("conditioned_gaussian", n=64, m=4, cond=10.0, seed=3)


@pytest.fixture(scope="module")
def ls_systems():
    return _pair("tall_gaussian", N=240, n=120, m=4, seed=0, noise=0.05)


@pytest.fixture(scope="module")
def sparse_systems():
    return _pair("banded_system", n=192, m=4, bandwidth=6, seed=0)


@pytest.fixture(scope="module")
def mesh(group):
    return mesh_lib.solver_mesh(1, 1, device="cpu")


def _mesh_plan(mesh, **kw):
    return ExecutionPlan(backend="mesh", mesh=mesh, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _match(r_port, r_ref, *, errors=True):
    np.testing.assert_allclose(_np(r_port.x), _np(r_ref.x), **X_TOL)
    np.testing.assert_allclose(_np(r_port.residuals),
                               _np(r_ref.residuals), **H_TOL)
    if errors:
        np.testing.assert_allclose(_np(r_port.errors), _np(r_ref.errors),
                                   **H_TOL)
    np.testing.assert_array_equal(np.asarray(r_port.iters_to_tol),
                                  np.asarray(r_ref.iters_to_tol))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# mesh == local (tests/test_mesh_backend.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_mesh_matches_local(systems, mesh, name):
    """backend='mesh' returns the reference's local SolveResult; the
    port's own local run is printed beside it (max|Δ|, no bit claim: the
    mesh's master update is a psum over m, the local one a mean)."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r_ref = ref_solvers.get(name).solve(ref_sys, iters=ITERS, **prm)
    s = solvers.get(name)
    r = s.solve(sys_, iters=ITERS, plan=_mesh_plan(mesh), **prm)
    assert r.name == name
    assert r.residuals.shape == (ITERS,)
    assert r.errors is not None
    assert r.params == prm
    assert r.state.t == ITERS
    _match(r, r_ref)
    r_loc = s.solve(sys_, iters=ITERS, **prm)
    print(name, "mesh vs port local max|dx|",
          float((r.x - r_loc.x).abs().max()))


@pytest.mark.parametrize("name", ALL)
def test_mesh_state_roundtrips_with_local(systems, mesh, name):
    """Warm starts cross backends both ways, with global shapes: mesh ->
    local and local -> mesh resume like an uninterrupted run."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    full = ref_solvers.get(name).solve(ref_sys, iters=100, **prm)
    s = solvers.get(name)
    half_m = s.solve(sys_, iters=50, plan=_mesh_plan(mesh), **prm)
    res_l = s.solve(sys_, iters=50,
                    plan=ExecutionPlan(warm_state=half_m.state), **prm)
    np.testing.assert_allclose(_np(res_l.x), _np(full.x), **X_TOL)
    assert res_l.state.t == 100
    half_l = s.solve(sys_, iters=50, **prm)
    res_m = s.solve(sys_, iters=50,
                    plan=_mesh_plan(mesh, warm_state=half_l.state), **prm)
    np.testing.assert_allclose(_np(res_m.x), _np(full.x), **X_TOL)
    assert res_m.state.t == 100
    for a, b in zip(half_m.state, half_l.state):
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape


def test_mesh_state_roundtrips_through_checkpoint(systems, mesh, tmp_path):
    ref_sys, sys_ = systems
    prm = ref_solvers.get("apc").resolve_params(ref_sys)
    s = solvers.get("apc")
    r1 = s.solve(sys_, iters=40, plan=_mesh_plan(mesh), **prm)
    ckpt.save(str(tmp_path), 40, r1.state)
    restored = ckpt.restore(str(tmp_path), r1.state)
    r2 = s.solve(sys_, iters=40, plan=_mesh_plan(mesh, warm_state=restored),
                 **prm)
    full = ref_solvers.get("apc").solve(ref_sys, iters=80, **prm)
    np.testing.assert_allclose(_np(r2.x), _np(full.x), **X_TOL)
    assert r2.state.t == 80


@pytest.mark.parametrize("name", ["apc", "dhbm", "madmm"])
def test_mesh_solve_many_matches_local(systems, mesh, name):
    ref_sys, sys_ = systems
    B = np.random.default_rng(4).standard_normal((3, sys_.N))
    rl = ref_solvers.get(name).solve_many(ref_sys, B, iters=100)
    rm = solvers.get(name).solve_many(sys_, B, iters=100,
                                      plan=_mesh_plan(mesh))
    assert rm.x.shape == (3, sys_.n)
    assert rm.residuals.shape == (3, 100)
    assert rm.errors is None
    _match(rm, rl, errors=False)


def test_mesh_rejects_kernel_and_unknown_backend(systems, mesh):
    """As the reference: kernel=True on a solver without a kernel, an
    unknown backend, and a mesh with the local backend are refused."""
    _, sys_ = systems
    with pytest.raises(ValueError, match="kernel"):
        solvers.get("dgd").solve(sys_, iters=5,
                                 plan=_mesh_plan(mesh, kernel=True))
    s = solvers.get("apc")
    with pytest.raises(ValueError, match="backend"):
        s.solve(sys_, iters=5, plan=ExecutionPlan(backend="bogus"))
    with pytest.raises(ValueError, match="backend='mesh'"):
        s.solve(sys_, iters=5, plan=ExecutionPlan(mesh=mesh))
    with pytest.raises(ValueError, match="backend='mesh'"):
        s.solve_many(sys_, np.ones((2, sys_.N)), iters=5,
                     plan=ExecutionPlan(mesh=mesh))
    # redundancy runs on the mesh (A15, tests/test_torch_redundant.py);
    # with kernel=True it is the reference's CapabilityError
    with pytest.raises(solvers.CapabilityError, match="use_kernel"):
        s.solve(sys_, iters=5, plan=_mesh_plan(mesh, redundancy=2,
                                               kernel=True))


def test_mesh_context_validates_axes(systems, group):
    _, sys_ = systems
    mesh1 = mesh_lib.make_mesh((1,), ("data",), device="cpu")
    ctx = mesh_backend.make_context(mesh1, sys_)   # model axis absent
    assert ctx.model_axis is None and ctx.worker_axes == ("data",)
    assert ctx.workers == 1 and ctx.model_shards == 1
    with pytest.raises(ValueError, match="worker axes"):
        mesh_backend.make_context(mesh1, sys_, worker_axes=("pod",))
    with pytest.raises(ValueError, match="covers every rank"):
        mesh_lib.make_mesh((2, 1), ("data", "model"), device="cpu")


def test_unimplemented_solver_raises(systems, mesh):
    class Bare(solvers.Solver):
        name = "bare"

    with pytest.raises(NotImplementedError, match="mesh backend"):
        mesh_backend.solve_mesh(Bare(), systems[1], mesh=mesh, iters=2)


def test_default_mesh_and_signature(systems):
    """mesh=None builds ``solver_mesh_for(m)`` over the group (here
    (1, 1)); the plan's signature carries its axes, as the
    reference's."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get("dgd").resolve_params(ref_sys)
    r = solvers.get("dgd").solve(sys_, iters=30,
                                 plan=ExecutionPlan(backend="mesh"), **prm)
    r_ref = ref_solvers.get("dgd").solve(ref_sys, iters=30, **prm)
    _match(r, r_ref)
    for kw in ({}, dict(backend="mesh", worker_axes=["pod", "data"],
                        model_axis=None, kernel=True)):
        assert ExecutionPlan(**kw).signature() == \
            ref_solvers.ExecutionPlan(**kw).signature()


def test_host_meshes_fit_the_group(group):
    """``make_host_mesh`` and ``solver_mesh_for`` cut their axes to the
    world size, as the reference's cut theirs to the device count: a
    (1, 1) mesh on one rank, whatever is asked."""
    for mesh in (mesh_lib.make_host_mesh(4, 2, device="cpu"),
                 mesh_lib.solver_mesh_for(16, device="cpu")):
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh_lib.mesh_device(mesh) == torch.device("cpu")


def test_cuda_mesh_without_cuda_raises(group):
    """No fallback: a mesh on the card raises where there is none."""
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.solver_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.init_group("cuda")


# ---------------------------------------------------------------------------
# least squares and sparse (tests/test_modes.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cimmino", "dgd"])
def test_ls_mesh_matches_local(ls_systems, mesh, name):
    ref_sys, sys_ = ls_systems
    assert sys_.mode == "least_squares"
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r_ref = ref_solvers.get(name).solve(ref_sys, iters=300, **prm)
    r = solvers.get(name).solve(sys_, iters=300, plan=_mesh_plan(mesh),
                                **prm)
    _match(r, r_ref)


@pytest.mark.parametrize("name", ["apc", "dgd"])
def test_sparse_mesh_matches_local(sparse_systems, mesh, name):
    ref_sys, sys_ = sparse_systems
    assert sys_.is_sparse
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r_ref = ref_solvers.get(name).solve(ref_sys, iters=ITERS, **prm)
    r = solvers.get(name).solve(sys_, iters=ITERS, plan=_mesh_plan(mesh),
                                **prm)
    _match(r, r_ref)


def test_ls_solve_many_mesh(ls_systems, mesh):
    """The batched LS optimality residual on the mesh."""
    ref_sys, sys_ = ls_systems
    B = np.random.default_rng(2).standard_normal((3, sys_.N))
    prm = ref_solvers.get("dgd").resolve_params(ref_sys)
    rl = ref_solvers.get("dgd").solve_many(ref_sys, B, iters=200, **prm)
    rm = solvers.get("dgd").solve_many(sys_, B, iters=200,
                                       plan=_mesh_plan(mesh), **prm)
    _match(rm, rl, errors=False)


# ---------------------------------------------------------------------------
# the kernel path: the split gather -> psum_model -> scatter
# ---------------------------------------------------------------------------


@pytest.fixture
def fused(monkeypatch):
    """Both packages' local kernel path pinned fused (their CPU default
    runs Cimmino unfused below k = 8); the mesh's asks no verdict."""
    monkeypatch.setenv("REPRO_KERNEL_ENGINE", "fused")


def _kernel_match(r, r_ref):
    assert _rel(r.x, r_ref.x) <= 1e-6
    np.testing.assert_allclose(_np(r.residuals), _np(r_ref.residuals),
                               **K_TOL)


@pytest.mark.parametrize("name", PROJ)
def test_kernel_mesh_matches_reference_kernel(systems, mesh, fused, name):
    """kernel=True on the mesh (the fused residual included) against the
    reference's local kernel path and the port's unfused mesh path."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r_ref = ref_solvers.get(name).solve(
        ref_sys, iters=KITERS, plan=ref_solvers.ExecutionPlan(kernel=True),
        **prm)
    before = ops.launch_counts()
    r = solvers.get(name).solve(sys_, iters=KITERS,
                                plan=_mesh_plan(mesh, kernel=True), **prm)
    assert ops.launch_counts() == before     # plain versions on the CPU
    _kernel_match(r, r_ref)
    np.testing.assert_allclose(_np(r.errors), _np(r_ref.errors), **K_TOL)
    r_u = solvers.get(name).solve(sys_, iters=KITERS, plan=_mesh_plan(mesh),
                                  **prm)
    _kernel_match(r, r_u)


@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_kernel_mesh_solve_many(systems, mesh, fused, name):
    ref_sys, sys_ = systems
    B = np.random.default_rng(5).standard_normal((3, sys_.N))
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    rl = ref_solvers.get(name).solve_many(
        ref_sys, B, iters=KITERS, plan=ref_solvers.ExecutionPlan(kernel=True),
        **prm)
    rm = solvers.get(name).solve_many(sys_, B, iters=KITERS,
                                      plan=_mesh_plan(mesh, kernel=True),
                                      **prm)
    _kernel_match(rm, rl)


@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_sparse_kernel_mesh(sparse_systems, mesh, fused, name):
    """The sparse kernels per worker (model axis off) on the mesh."""
    ref_sys, sys_ = sparse_systems
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    r_ref = ref_solvers.get(name).solve(
        ref_sys, iters=KITERS, plan=ref_solvers.ExecutionPlan(kernel=True),
        **prm)
    r = solvers.get(name).solve(sys_, iters=KITERS,
                                plan=_mesh_plan(mesh, kernel=True), **prm)
    _kernel_match(r, r_ref)


def test_mixed_precision_mesh_matches_local(systems, mesh, fused):
    """precision="mixed" on the mesh: the bf16-stored factors cast last,
    the port's local mixed run within 1e-9 (the same maths); and, on the
    reference's mixed factors carried in by their bits (the port's own B
    may round to another bf16 in the last place), the reference's local
    mixed kernel run (interpret mode) at tests/test_torch_mixed.py's
    parity tolerances."""
    ref_sys, sys_ = systems
    ref = ref_solvers.get("apc")
    prm = ref.resolve_params(ref_sys)
    s = solvers.get("apc")
    r = s.solve(sys_, iters=ITERS,
                plan=_mesh_plan(mesh, kernel=True, precision="mixed"), **prm)
    r_loc = s.solve(sys_, iters=ITERS,
                    plan=ExecutionPlan(kernel=True, precision="mixed"), **prm)
    np.testing.assert_allclose(_np(r.residuals), _np(r_loc.residuals),
                               rtol=0, atol=1e-9)
    assert _rel(r.x, r_loc.x) <= 1e-9
    r_ref = ref.solve(ref_sys, iters=MIXED_ITERS,
                      plan=ref_solvers.ExecutionPlan(kernel=True,
                                                     precision="mixed"),
                      **prm)
    f = ref.cast_factors(ref.kernel_factors(ref.prepare(ref_sys.A_op, prm)),
                         "mixed")
    facs = interop.from_numpy(ProjFactors, *f, device="cpu")
    assert facs.A.dtype == facs.B.dtype == torch.bfloat16
    r = s.solve(sys_, iters=MIXED_ITERS, plan=_mesh_plan(
        mesh, kernel=True, precision="mixed", factors=facs), **prm)
    assert r.x.dtype == torch.float64
    assert _rel(r.x, r_ref.x) < 1e-9
    for got, want in ((r.residuals, r_ref.residuals),
                      (r.errors, r_ref.errors)):
        np.testing.assert_allclose(_np(got), _np(want), **MIXED_HIST)
    assert r.iters_to_tol == r_ref.iters_to_tol


# ---------------------------------------------------------------------------
# the hooks against the reference's, outside shard_map
# ---------------------------------------------------------------------------


class _Identity:
    """An identity mesh context for the reference's hooks called outside
    shard_map: one shard, so both psums return their input."""
    w = "data"
    n = None

    @staticmethod
    def psum_workers(v):
        return v

    @staticmethod
    def psum_model(v):
        return v

    @staticmethod
    def workers_total(m):
        return m


def _close_tree(port, ref):
    """Every tensor field of ``port`` within HOOK_TOL of ``ref``'s."""
    for f in port._fields:
        p, r = getattr(port, f), getattr(ref, f)
        if p is None:
            assert r is None, f
            continue
        if not isinstance(p, torch.Tensor):     # the counter (vmapped:
            assert (np.asarray(r) == p).all(), f  # one a batch row)
            continue
        r = np.asarray(r, dtype=np.float64)
        d = float(np.abs(p.double().numpy() - r).max()) if r.size else 0.0
        assert d <= HOOK_TOL * (float(np.abs(r).max()) + 1.0), (f, d)


def _hook_inputs(systems, name):
    ref_sys, sys_ = systems
    prm = ref_solvers.get(name).resolve_params(ref_sys)
    Bm = np.random.default_rng(6).standard_normal((3, sys_.m, sys_.p))
    return prm, ref_sys, sys_, Bm


@pytest.mark.parametrize("name", ALL)
def test_hooks_match_reference_hooks(systems, mesh, name):
    """mesh_prepare, mesh_init, three mesh_steps, mesh_step_residual
    (where the solver has it) and the batched init and mesh_step_many,
    the port's on a one-rank MeshContext against the reference's with an
    identity context."""
    prm, ref_sys, sys_, Bm = _hook_inputs(systems, name)
    ref, s = ref_solvers.get(name), solvers.get(name)
    ctx_r, ctx = _Identity(), mesh_backend.make_context(mesh, sys_)
    f_r = ref.mesh_prepare(ref_sys.A_blocks, prm, ctx_r)
    f = s.mesh_prepare(sys_.A_blocks, prm, ctx)
    _close_tree(f, f_r)
    st_r = ref.mesh_init(f_r, ref_sys.b_blocks, prm, ctx_r)
    st = s.mesh_init(f, sys_.b_blocks, prm, ctx)
    _close_tree(st, st_r)
    for _ in range(3):
        st_r = ref.mesh_step(f_r, ref_sys.b_blocks, st_r, prm, ctx_r)
        st = s.mesh_step(f, sys_.b_blocks, st, prm, ctx)
        _close_tree(st, st_r)
    if s.supports_fused_residual:
        (st_r, rsq_r) = ref.mesh_step_residual(f_r, ref_sys.b_blocks, st_r,
                                               prm, ctx_r)
        st, rsq = s.mesh_step_residual(f, sys_.b_blocks, st, prm, ctx)
        _close_tree(st, st_r)
        assert abs(float(rsq) - float(rsq_r)) <= HOOK_TOL * (
            abs(float(rsq_r)) + 1.0)
    sts_r = jax.vmap(lambda bb: ref.mesh_init(f_r, bb, prm, ctx_r))(
        jnp.asarray(Bm))
    sts = s.mesh_init(f, torch.as_tensor(Bm), prm, ctx)
    _close_tree(sts, sts_r)
    sts_r = ref.mesh_step_many(f_r, jnp.asarray(Bm), sts_r, prm, ctx_r)
    sts = s.mesh_step_many(f, torch.as_tensor(Bm), sts, prm, ctx)
    _close_tree(sts, sts_r)


@pytest.mark.parametrize("name", PROJ)
def test_kernel_hooks_match_reference_hooks(systems, mesh, name):
    """The kernel path's hooks: the on-mesh pinv factors, the split
    gather -> psum_model -> scatter step, its fused residual and the
    batched step (the reference's Pallas kernels in interpret mode)."""
    prm, ref_sys, sys_, Bm = _hook_inputs(systems, name)
    ref, s = ref_solvers.get(name), solvers.get(name)
    ctx_r, ctx = _Identity(), mesh_backend.make_context(mesh, sys_)
    f_r = ref.mesh_prepare(ref_sys.A_blocks, prm, ctx_r, use_kernel=True)
    f = s.mesh_prepare(sys_.A_blocks, prm, ctx, use_kernel=True)
    _close_tree(f, f_r)
    st_r = ref.mesh_init(f_r, ref_sys.b_blocks, prm, ctx_r)
    st = s.mesh_init(f, sys_.b_blocks, prm, ctx)
    st_r = ref.mesh_step(f_r, ref_sys.b_blocks, st_r, prm, ctx_r,
                         use_kernel=True)
    st = s.mesh_step(f, sys_.b_blocks, st, prm, ctx, use_kernel=True)
    _close_tree(st, st_r)
    st_r, rsq_r = ref.mesh_step_residual(f_r, ref_sys.b_blocks, st_r, prm,
                                         ctx_r)
    st, rsq = s.mesh_step_residual(f, sys_.b_blocks, st, prm, ctx)
    _close_tree(st, st_r)
    assert abs(float(rsq) - float(rsq_r)) <= HOOK_TOL * (
        abs(float(rsq_r)) + 1.0)
    sts_r = jax.vmap(lambda bb: ref.mesh_init(f_r, bb, prm, ctx_r))(
        jnp.asarray(Bm))
    sts = s.mesh_init(f, torch.as_tensor(Bm), prm, ctx)
    sts_r = ref.mesh_step_many(f_r, jnp.asarray(Bm), sts_r, prm, ctx_r,
                               use_kernel=True)
    sts = s.mesh_step_many(f, torch.as_tensor(Bm), sts, prm, ctx,
                           use_kernel=True)
    _close_tree(sts, sts_r)


# ---------------------------------------------------------------------------
# the store across backends, the core shim, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True])
def test_store_entries_cross_backends(systems, mesh, tmp_path, kernel):
    """A mesh miss runs the on-mesh prepare and inserts the global
    factors (the disk tier written): a local solve hits them; a fresh
    store's disk hit serves the mesh; the kernel augmentation happens
    once per entry."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get("apc").resolve_params(ref_sys)
    s = solvers.get("apc")
    store = solvers.FactorStore(directory=str(tmp_path))
    r_m = s.solve(sys_, iters=40, plan=_mesh_plan(mesh, store=store,
                                                 kernel=kernel), **prm)
    assert (store.stats.misses, store.stats.hits) == (1, 0)
    entry = store._mem[store.key(s, sys_, **prm)]
    assert entry.A.shape == sys_.A_blocks.shape
    assert (entry.B is not None) == kernel
    r_l = s.solve(sys_, iters=40, plan=ExecutionPlan(store=store,
                                                     kernel=kernel), **prm)
    assert (store.stats.misses, store.stats.hits) == (1, 1)
    assert store._mem[store.key(s, sys_, **prm)] is entry   # augmented once
    _kernel_match(r_m, r_l)
    cold = solvers.FactorStore(directory=str(tmp_path))
    r_d = s.solve(sys_, iters=40, plan=_mesh_plan(mesh, store=cold,
                                                 kernel=kernel), **prm)
    assert (cold.stats.disk_hits, cold.stats.misses) == (1, 0)
    assert torch.equal(r_d.x, r_m.x)


def test_core_distributed_shim(systems, mesh):
    """``core.distributed``: the one-call driver and the raw-shard step
    and residual, against the reference's local APC."""
    ref_sys, sys_ = systems
    prm = ref_solvers.get("apc").resolve_params(ref_sys)
    x, res = distributed.solve_on_mesh(mesh, sys_, iters=ITERS, **prm)
    r_ref = ref_solvers.get("apc").solve(ref_sys, iters=ITERS, **prm)
    np.testing.assert_allclose(_np(x), _np(r_ref.x), **X_TOL)
    assert res == pytest.approx(float(r_ref.residuals[-1]), rel=1e-6,
                                abs=1e-12)
    sh = distributed.make_sharded_apc(mesh, worker_axes=("data", "pod"),
                                      **prm)
    assert sh.worker_axes == ("data",) and sh.model_axis == "model"
    A, b, chol, xw, xbar = distributed.prepare_on_mesh(sh, sys_)
    step, residual = sh.step_fn(), sh.residual_fn()
    for _ in range(ITERS):
        xw, xbar = step(A, chol, xw, xbar)
    np.testing.assert_allclose(_np(xbar), _np(r_ref.x), **X_TOL)
    assert float(residual(A, b, xbar)) == pytest.approx(
        float(r_ref.residuals[-1]), rel=1e-6, abs=1e-12)


def test_cli_use_mesh_prints_the_reference_lines():
    """``--use-mesh`` on a one-rank group: the reference CLI's lines (its
    own mesh cannot run, C0: held to its local run), the mesh's shape."""
    argv = ["--problem", "ash608", "--workers", "4", "--iters", "30",
            "--use-kernel"]
    outs = []
    for main, extra in ((ref_cli.main, []),
                        (cli.main, ["--device", "cpu", "--use-mesh"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert main(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert "mesh backend: (('data', 1), ('model', 1)) over 1 rank(s)" \
        in lines
    lines = [ln for ln in lines if not ln.startswith("mesh backend")]
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]
