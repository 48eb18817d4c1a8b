"""The port's APC solve against the JAX reference, end to end on the CPU.

Same seeded system through both packages: the same parameters, x to
1e-9 relative, residual and error histories to 1e-9 absolute (they are
relative norms <= ~1), the same iters_to_tol.  The kernel path runs the
plain versions here (tensors on the CPU) and the reference's Pallas
kernels in interpret mode, kept to 20 iterations.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.launch import solve as ref_cli  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core.apc import APCState  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import solve as cli  # noqa: E402
from repro_torch.solvers.projection import ProjFactors  # noqa: E402

torch.set_num_threads(1)

SYS = dict(n=128, m=4, cond=20.0, seed=3)
HIST = dict(rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def systems():
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


@pytest.fixture(scope="module")
def params(systems):
    return ref_solvers.get("apc").resolve_params(systems[0])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _agree(r_port, r_ref):
    assert _rel(r_port.x, r_ref.x) < 1e-9
    np.testing.assert_allclose(r_port.residuals.numpy(),
                               np.asarray(r_ref.residuals), **HIST)
    if r_ref.errors is not None:
        np.testing.assert_allclose(r_port.errors.numpy(),
                                   np.asarray(r_ref.errors), **HIST)
    np.testing.assert_array_equal(r_port.iters_to_tol, r_ref.iters_to_tol)


def test_params_match(systems):
    (p_ref, rho_ref) = ref_solvers.get("apc").analyze(systems[0])
    (p_port, rho_port) = solvers.get("apc").analyze(systems[1])
    assert p_port.keys() == p_ref.keys()
    for key in p_ref:
        assert p_port[key] == pytest.approx(p_ref[key], rel=1e-10)
    assert rho_port == pytest.approx(rho_ref, rel=1e-10)
    assert solvers.available() == ref_solvers.available()


@pytest.mark.parametrize("kernel,iters", [(False, 150), (True, 20)])
def test_solve_matches_reference(systems, kernel, iters):
    ref_sys, sys_ = systems
    r_ref = ref_solvers.get("apc").solve(
        ref_sys, iters=iters, plan=ref_solvers.ExecutionPlan(kernel=kernel))
    r = solvers.get("apc").solve(
        sys_, iters=iters, plan=solvers.ExecutionPlan(kernel=kernel))
    assert r.params == pytest.approx(r_ref.params, rel=1e-10)
    _agree(r, r_ref)
    if not kernel:
        assert r.iters_to_tol > 0            # the comparison is not vacuous


def test_fused_residual_matches_separate_pass(systems, params):
    """kernel=True records the residual from the gather pass, shifted by
    one and closed by one true-A pass (tests/test_kernel_corners.py)."""
    s = solvers.get("apc")
    r_k = s.solve(systems[1], iters=80,
                  plan=solvers.ExecutionPlan(kernel=True), **params)
    r = s.solve(systems[1], iters=80, **params)
    np.testing.assert_allclose(r_k.residuals.numpy(), r.residuals.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(r_k.errors.numpy(), r.errors.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel,iters", [(False, 120), (True, 20)])
def test_solve_many_matches_reference_and_row_loop(systems, params, kernel,
                                                   iters):
    ref_sys, sys_ = systems
    rng = np.random.default_rng(9)
    Bm = rng.standard_normal((4, sys_.N))
    plan = solvers.ExecutionPlan(kernel=kernel)
    r_ref = ref_solvers.get("apc").solve_many(
        ref_sys, Bm, iters=iters,
        plan=ref_solvers.ExecutionPlan(kernel=kernel), **params)
    r = solvers.get("apc").solve_many(sys_, Bm, iters=iters, plan=plan,
                                      **params)
    assert r.x.shape == (4, sys_.n) and r.residuals.shape == (4, iters)
    _agree(r, r_ref)
    for i in range(4):
        row = partition(sys_.A_blocks.reshape(sys_.N, sys_.n),
                        torch.as_tensor(Bm[i]), sys_.m)
        r_i = solvers.get("apc").solve(row, iters=iters, plan=plan,
                                       **params)
        np.testing.assert_allclose(r.x[i].numpy(), r_i.x.numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r.residuals[i].numpy(),
                                   r_i.residuals.numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel", [False, True])
def test_reference_state_continues_in_port(systems, params, kernel):
    """A reference ProjFactors/APCState, carried across with interop,
    continues for 5 steps as the reference does (1e-12)."""
    ref_sys, _ = systems
    s_ref, s = ref_solvers.get("apc"), solvers.get("apc")
    f_ref = s_ref.prepare(ref_sys.A_blocks, params)
    if kernel:
        f_ref = s_ref.kernel_factors(f_ref)
    st_ref = s_ref.init(f_ref, ref_sys.b_blocks, params)
    for _ in range(3):
        st_ref = s_ref.step(f_ref, ref_sys.b_blocks, st_ref, params,
                            use_kernel=kernel)
    f = interop.from_numpy(
        ProjFactors, *(None if a is None else np.asarray(a) for a in f_ref),
        device="cpu")
    st = interop.from_numpy(APCState, *(np.asarray(a) for a in st_ref),
                            device="cpu")
    b = interop.system_from_numpy(ref_sys.A_blocks, ref_sys.b_blocks,
                                  device="cpu").b_blocks
    assert st.t == 3
    for _ in range(5):
        st_ref = s_ref.step(f_ref, ref_sys.b_blocks, st_ref, params,
                            use_kernel=kernel)
        st = s.step(f, b, st, params, use_kernel=kernel)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_ref.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.xbar.numpy(), np.asarray(st_ref.xbar),
                               rtol=1e-12, atol=1e-12)
    assert st.t == int(st_ref.t) == 8


def test_warm_state_resumes_exactly(systems, params):
    s = solvers.get("apc")
    full = s.solve(systems[1], iters=40, **params)
    half = s.solve(systems[1], iters=20, **params)
    rest = s.solve(systems[1], iters=20,
                   plan=solvers.ExecutionPlan(warm_state=half.state),
                   **params)
    assert torch.equal(rest.x, full.x)
    assert rest.state.t == 40


def test_plan_rejections(systems):
    s, sys_ = solvers.get("apc"), systems[1]
    for plan, item in [(solvers.ExecutionPlan(backend="mesh"), "A14"),
                       (solvers.ExecutionPlan(redundancy=2), "A15")]:
        with pytest.raises(NotImplementedError, match=item):
            s.solve(sys_, iters=1, plan=plan, gamma=1.0, eta=1.0)
    # the store is ported (A12, tests/test_torch_store.py): the plan takes
    # a FactorStore, and anything else fails where the store is used
    with pytest.raises(AttributeError, match="factors"):
        s.solve(sys_, iters=1, plan=solvers.ExecutionPlan(store=object()),
                gamma=1.0, eta=1.0)
    r = s.solve(sys_, iters=1, gamma=1.0, eta=1.0,
                plan=solvers.ExecutionPlan(store=solvers.FactorStore()))
    assert r.state.t == 1
    # precision="mixed" is ported; without the kernel path it is the
    # reference's error (tests/test_torch_mixed.py holds the rest)
    with pytest.raises(ValueError, match="use_kernel"):
        s.solve(sys_, iters=1, plan=solvers.ExecutionPlan(precision="mixed"),
                gamma=1.0, eta=1.0)
    with pytest.raises(ValueError, match="backend"):
        s.solve(sys_, iters=1, plan=solvers.ExecutionPlan(backend="tpu"))
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((12, 5)))
    ls = partition(A, torch.ones(12, dtype=A.dtype), 3)
    assert ls.mode == "least_squares"
    with pytest.raises(solvers.CapabilityError, match="least_squares"):
        s.solve(ls, iters=1, gamma=1.0, eta=1.0)


def test_cli_prints_the_reference_lines():
    argv = ["--problem", "ash608", "--workers", "4", "--iters", "30"]
    outs = []
    for main, extra in ((ref_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]
    before = ops.launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv + ["--device", "cpu", "--use-kernel"]) == 0
    assert ops.launch_counts() == before
