"""Block Cimmino and consensus in the port against the JAX reference.

On the CPU the port's ``cimmino_gather``/``cimmino_scatter``/
``cimmino_update`` run their plain PyTorch versions; the reference's ops
run their Pallas kernels in interpret mode, as tests/test_kernels.py runs
them.  The reference's engine is pinned to the fused kernels
(``REPRO_KERNEL_ENGINE=fused``, as tests/test_engine_autotune.py does) so
its kernel path is the kernel path at every batch size, as the port's is.
The CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.core.apc import APCState  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py; bf16 relative to max|ref| + 1, as its TOL
TOL = {np.float32: 2e-5, np.float64: 1e-12, jnp.bfloat16: 8e-2}
M = 3
SYS = dict(n=80, m=4, cond=10.0, seed=11)
HIST = dict(rtol=0, atol=1e-10)
KERNEL_ITERS = 20          # the reference's kernel path runs interpreted


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv(ref_ops.ENGINE_ENV, "fused")


@pytest.fixture(scope="module")
def systems():
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


def _inputs(p, n, k, dtype, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, p, n))
    G = np.einsum("mpn,mqn->mpq", A, A)
    B = np.linalg.solve(G, A).transpose(0, 2, 1)            # (m, n, p)
    xb = rng.standard_normal((n,) if k == 1 else (k, n))
    b = rng.standard_normal((M, p) if k == 1 else (M, k, p))
    return [a.astype(dtype) for a in (A, B, xb, b)]


def _torch(a):
    """A numpy array as a torch tensor, a bf16 one bit for bit."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.as_tensor(a)


def _err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, jnp.bfloat16])
@pytest.mark.parametrize("p,n,k", [(8, 128, 1), (16, 512, 16), (7, 130, 5),
                                   (1, 128, 4), (24, 896, 1)])
def test_cimmino_ops_match_reference(p, n, k, dtype):
    """m = 3 workers against the reference's worker-vmapped Pallas ops
    and its jnp oracles; bfloat16 is the all-bf16 form, fed the same
    bits."""
    A, B, xb, b = _inputs(p, n, k, dtype)
    J = [jnp.asarray(a) for a in (A, B, xb, b)]
    u_ref = jax.vmap(ref_ops.cimmino_gather, in_axes=(0, None))(J[0], J[2])
    v_ref = J[3] - u_ref
    r_ref = jax.vmap(ref_ops.cimmino_scatter)(J[1], v_ref)
    full_ref = jax.vmap(ref_ops.cimmino_update, in_axes=(0, 0, 0, None))(
        J[0], J[1], J[3], J[2])
    full_or = jax.vmap(ref_ref.cimmino_update_ref, in_axes=(0, 0, 0, None))(
        J[0], J[1], J[3], J[2])
    T = [_torch(a) for a in (A, B, xb, b)]
    before = ops.launch_counts()
    u = ops.cimmino_gather(T[0], T[2])
    # the scatter consumes the reference's v, as its test does
    r = ops.cimmino_scatter(T[1], _torch(np.array(v_ref)))
    full = ops.cimmino_update(T[0], T[1], T[3], T[2])
    assert ops.launch_counts() == before     # CPU tensors never launch
    assert u.dtype == r.dtype == full.dtype == T[0].dtype
    tol = TOL[dtype]
    assert _err(u, u_ref) < tol
    assert _err(r, r_ref) < tol
    assert _err(full, full_ref) < tol
    assert _err(full, full_or) < tol
    assert _err(ops.cimmino_update_ref(T[0], T[1], T[3], T[2]),
                full_or) < tol


def test_plain_versions_are_the_worker_loop():
    """The batched plain versions equal a loop over workers and rows of
    the reference's single-RHS oracles, and the (m, k, p) transposed view
    of a (k, m, p) batch gives the same result as a contiguous copy."""
    A, B, xb, b = _inputs(6, 40, 4, np.float64, seed=2)
    T = [torch.as_tensor(a) for a in (A, B, xb, b)]
    r = ops.cimmino_update(T[0], T[1], T[3], T[2]).numpy()
    for w in range(M):
        for i in range(4):
            np.testing.assert_allclose(
                r[w, i], np.asarray(ref_ref.cimmino_update_ref(
                    A[w], B[w], b[w, i], xb[i])), rtol=1e-13, atol=1e-13)
    Vt = T[3].transpose(0, 1).contiguous().transpose(0, 1)
    assert not Vt.is_contiguous()
    assert torch.equal(ops.cimmino_scatter(T[1], Vt),
                       ops.cimmino_scatter(T[1], T[3]))


def test_launchers_take_cuda_tensors_only():
    A, B, xb, b = (torch.as_tensor(a) for a in _inputs(4, 16, 2,
                                                        np.float64))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bp.cimmino_gather(A, xb)
    with pytest.raises(ValueError, match="CUDA"):
        bp.cimmino_scatter(B, b)
    with pytest.raises(ValueError, match="meta"):
        ops.cimmino_gather(A.to("meta"), xb.to("meta"))
    with pytest.raises(TypeError, match="dtypes"):
        ops.cimmino_scatter(B, b.float())
    assert ops.launch_counts() == before


def _agree(r_port, r_ref):
    np.testing.assert_allclose(r_port.residuals.numpy(),
                               np.asarray(r_ref.residuals), **HIST)
    if r_ref.errors is not None:
        np.testing.assert_allclose(r_port.errors.numpy(),
                                   np.asarray(r_ref.errors), **HIST)
    np.testing.assert_allclose(r_port.x.numpy(), np.asarray(r_ref.x),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(r_port.iters_to_tol, r_ref.iters_to_tol)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", ["cimmino", "consensus"])
def test_solve_matches_reference(systems, fused, name, kernel):
    ref_sys, sys_ = systems
    iters = KERNEL_ITERS if kernel else 800
    r_ref = ref_solvers.get(name).solve(
        ref_sys, iters=iters, plan=ref_solvers.ExecutionPlan(kernel=kernel))
    r = solvers.get(name).solve(
        sys_, iters=iters, plan=solvers.ExecutionPlan(kernel=kernel))
    assert r.params == pytest.approx(r_ref.params, rel=1e-10)
    _agree(r, r_ref)
    if not kernel and name == "cimmino":
        assert r.iters_to_tol > 0            # the comparison is not vacuous


@pytest.mark.parametrize("name", ["cimmino", "consensus"])
def test_kernel_path_matches_unfused(systems, name):
    """The reference's kernel-path contract (tests/test_kernel_engine.py:
    rtol 1e-6), with the fused-residual history of the kernel path."""
    s, sys_ = solvers.get(name), systems[1]
    prm = s.resolve_params(sys_)
    rk = s.solve(sys_, iters=300, plan=solvers.ExecutionPlan(kernel=True),
                 **prm)
    ru = s.solve(sys_, iters=300, **prm)
    assert torch.allclose(rk.residuals, ru.residuals, rtol=1e-6, atol=1e-12)
    assert torch.allclose(rk.errors, ru.errors, rtol=1e-6, atol=1e-12)
    assert torch.allclose(rk.x, ru.x, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kernel", [False, True])
def test_solve_many_matches_reference_and_row_loop(systems, fused, kernel):
    ref_sys, sys_ = systems
    s = solvers.get("cimmino")
    prm = s.resolve_params(sys_)
    iters = KERNEL_ITERS if kernel else 300
    Bm = np.random.default_rng(9).standard_normal((4, sys_.N))
    plan = solvers.ExecutionPlan(kernel=kernel)
    r_ref = ref_solvers.get("cimmino").solve_many(
        ref_sys, Bm, iters=iters,
        plan=ref_solvers.ExecutionPlan(kernel=kernel), **prm)
    r = s.solve_many(sys_, Bm, iters=iters, plan=plan, **prm)
    assert r.x.shape == (4, sys_.n) and r.residuals.shape == (4, iters)
    _agree(r, r_ref)
    for i in range(4):
        row = partition(sys_.A_blocks.reshape(sys_.N, sys_.n),
                        torch.as_tensor(Bm[i]), sys_.m)
        r_i = s.solve(row, iters=iters, plan=plan, **prm)
        np.testing.assert_allclose(r.x[i].numpy(), r_i.x.numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r.residuals[i].numpy(),
                                   r_i.residuals.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_cimmino_is_apc_gamma1(systems):
    """Proposition 2 (tests/test_apc.py): block Cimmino == APC with
    gamma = 1 and eta = m nu, from x̄(0) = 0."""
    sys_ = systems[1]
    m, nu = sys_.m, 0.3 / sys_.m
    cim = solvers.get("cimmino").solve(sys_, iters=40, nu=nu)
    apc = solvers.get("apc")
    prm = {"gamma": 1.0, "eta": m * nu}
    factors = apc.prepare(sys_.A_op, prm)
    st = apc.init(factors, sys_.b_blocks, prm)
    st = APCState(x=st.x, xbar=torch.zeros_like(st.xbar), t=0)
    for _ in range(40):
        st = apc.step(factors, sys_.b_blocks, st, prm)
    assert float(torch.linalg.norm(st.xbar - cim.x)) < 1e-9


def test_consensus_rate_and_params(systems):
    ref_sys, sys_ = systems
    p_ref, rho_ref = ref_solvers.get("consensus").analyze(ref_sys)
    p, rho = solvers.get("consensus").analyze(sys_)
    assert p == p_ref == {"gamma": 1.0, "eta": 1.0}
    assert rho == pytest.approx(rho_ref, rel=1e-10)


def test_kernel_path_hands_the_scatter_a_unit_stride(systems, monkeypatch):
    """A right-hand-side batch of any layout — here the transpose of an
    (N, k) product, whose p axis is not the unit-stride one — reaches the
    scatter kernel as a v with a unit stride along p, as its launcher
    requires (the plain versions on the CPU accept any strides)."""
    sys_ = systems[1]
    s = solvers.get("cimmino")
    prm = s.resolve_params(sys_)
    seen = []
    scatter = ops.cimmino_scatter

    def checked(B, V):
        seen.append(V.stride(-1))
        return scatter(B, V)

    monkeypatch.setattr(ops, "cimmino_scatter", checked)
    xs = torch.as_tensor(np.random.default_rng(2).standard_normal((3,
                                                                   sys_.n)))
    Bm = (sys_.A_blocks.reshape(sys_.N, sys_.n) @ xs.T).T     # (k, N)
    assert Bm.stride(-1) != 1
    many = s.solve_many(sys_, Bm, iters=10,
                        plan=solvers.ExecutionPlan(kernel=True), **prm)
    one = s.solve_many(sys_, Bm.contiguous(), iters=10,
                       plan=solvers.ExecutionPlan(kernel=True), **prm)
    assert seen and set(seen) == {1}
    assert torch.equal(many.x, one.x)
    A, B, xb, b = (torch.as_tensor(a) for a in _inputs(5, 33, 3,
                                                        np.float64))
    bt = b.transpose(1, 2).contiguous().transpose(1, 2)
    assert bt.stride(-1) != 1
    ops.cimmino_update(A, B, bt, xb)
    assert seen[-1] == 1
