"""The port's eight-solver registry against the JAX reference.

Every solver on the reference's registry fixture
(tests/test_solvers_registry.py): the lifecycle round trip, convergence
within the reference's iteration budgets, the auto-tuned parameters, the
residual and error histories, and a reference state and factors carried
across by ``interop`` continuing to the reference's iterate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.core import precond as ref_precond  # noqa: E402
from repro.core import spectral as ref_spectral  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core import precond, spectral  # noqa: E402
from repro_torch.data import linsys  # noqa: E402

torch.set_num_threads(1)

ALL = ["apc", "cimmino", "consensus", "dgd", "dhbm", "dnag", "madmm", "pdhbm"]
# tests/test_solvers_registry.py: budgets for a residual < 1e-6
ITERS = {"apc": 400, "dhbm": 600, "dnag": 800, "pdhbm": 500, "cimmino": 2500,
         "consensus": 2500, "dgd": 4000, "madmm": 12000}
SYS = dict(n=80, m=4, cond=10.0, seed=11)
HIST = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def systems():
    return (ref_linsys.conditioned_gaussian(**SYS),
            linsys.conditioned_gaussian(**SYS, device="cpu"))


@pytest.fixture(scope="module")
def solves(systems):
    """name -> (port SolveResult, reference SolveResult) at ITERS[name],
    each solve run once for the module."""
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = (
                solvers.get(name).solve(systems[1], iters=ITERS[name]),
                ref_solvers.get(name).solve(systems[0], iters=ITERS[name]))
        return memo[name]
    return get


def test_registry_lists_the_reference_eight():
    assert solvers.available() == ALL == ref_solvers.available()
    with pytest.raises(KeyError):
        solvers.get("nope")
    for name in ALL:
        s, r = solvers.get(name), ref_solvers.get(name)
        assert s.param_names == r.param_names, name
        assert s.supports_kernel == r.supports_kernel, name
        assert s.supports_fused_residual == r.supports_fused_residual, name
        assert s.warm_rhs_ok == r.warm_rhs_ok, name
        assert s.paper_name == r.paper_name, name


@pytest.mark.parametrize("name", ALL)
def test_lifecycle_roundtrip_and_convergence(systems, solves, name):
    sys_ = systems[1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    factors = s.prepare(sys_.A_op, prm)
    state = s.init(factors, sys_.b_blocks, prm)
    for _ in range(3):
        state = s.step(factors, sys_.b_blocks, state, prm)
    assert s.extract(state).shape == (sys_.n,)
    assert state.t == 3
    res = solves(name)[0]
    assert res.name == name
    assert res.params.keys() >= set(s.param_names)
    assert float(res.residuals[-1]) < 1e-6, name
    assert res.iters_to_tol != -1 and res.iters_to_tol <= ITERS[name]


@pytest.mark.parametrize("name", ALL)
def test_default_params_match_reference(systems, name):
    p_ref = ref_solvers.get(name).default_params(systems[0])
    p = solvers.get(name).default_params(systems[1])
    assert p.keys() == p_ref.keys()
    for key in p_ref:
        assert p[key] == pytest.approx(p_ref[key], rel=1e-10), key


@pytest.mark.parametrize("name", ALL)
def test_histories_match_reference(solves, name):
    r, r_ref = solves(name)
    np.testing.assert_allclose(r.residuals.numpy(),
                               np.asarray(r_ref.residuals), **HIST)
    np.testing.assert_allclose(r.errors.numpy(), np.asarray(r_ref.errors),
                               **HIST)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(r_ref.x), rtol=0,
                               atol=1e-10)
    assert r.iters_to_tol == r_ref.iters_to_tol


@pytest.mark.parametrize("name,kernel", [(n, False) for n in ALL]
                         + [("cimmino", True), ("consensus", True)])
def test_reference_state_continues_in_port(systems, monkeypatch, name,
                                           kernel):
    """A reference state and factors, carried across with interop after 3
    steps, continue for 5 steps as the reference does (1e-12)."""
    monkeypatch.setenv(ref_ops.ENGINE_ENV, "fused")
    ref_sys, sys_ = systems
    s_ref, s = ref_solvers.get(name), solvers.get(name)
    prm = s_ref.resolve_params(ref_sys)
    f_ref = s_ref.prepare(ref_sys.A_blocks, prm)
    if kernel:
        f_ref = s_ref.kernel_factors(f_ref)
    st_ref = s_ref.init(f_ref, ref_sys.b_blocks, prm)
    for _ in range(3):
        st_ref = s_ref.step(f_ref, ref_sys.b_blocks, st_ref, prm,
                            use_kernel=kernel)
    # the port's own types name the NamedTuples to convert into
    f_own = s.prepare(sys_.A_op, prm)
    if kernel:
        f_own = s.kernel_factors(f_own)
    st_own = s.init(f_own, sys_.b_blocks, prm)
    f = interop.from_numpy(
        type(f_own), *(None if a is None else np.asarray(a) for a in f_ref),
        device="cpu")
    st = interop.from_numpy(type(st_own), *(np.asarray(a) for a in st_ref),
                            device="cpu")
    assert st.t == 3
    for _ in range(5):
        st_ref = s_ref.step(f_ref, ref_sys.b_blocks, st_ref, prm,
                            use_kernel=kernel)
        st = s.step(f, sys_.b_blocks, st, prm, use_kernel=kernel)
    for got, want in zip(st, st_ref):
        if isinstance(got, int):
            assert got == int(want) == 8
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)


def test_spectral_closed_forms_match_reference(systems):
    ref_sys, sys_ = systems
    want = ref_spectral.rates_summary(ref_sys)
    got = spectral.rates_summary(sys_)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-10), key
    lam_ref = ref_spectral.ata_extremes(ref_sys)
    assert spectral.ata_extremes(sys_) == pytest.approx(lam_ref, rel=1e-10)
    X = spectral.x_matrix(sys_)
    assert spectral.kappa(X) == pytest.approx(
        ref_spectral.kappa(ref_spectral.x_matrix(ref_sys)), rel=1e-10)
    lmin, lmax = lam_ref
    for fn in ("dgd_optimal", "dnag_optimal", "dhbm_optimal"):
        assert getattr(spectral, fn)(lmin, lmax) == pytest.approx(
            getattr(ref_spectral, fn)(lmin, lmax), rel=1e-14), fn
    assert spectral.cimmino_optimal(0.2, 0.9) == pytest.approx(
        ref_spectral.cimmino_optimal(0.2, 0.9), rel=1e-14)
    assert spectral.consensus_rate(0.2) == ref_spectral.consensus_rate(0.2)


def test_precondition_matches_reference(systems):
    ref_sys, sys_ = systems
    ref_c = ref_precond.precondition(ref_sys)
    c = precond.precondition(sys_)
    np.testing.assert_allclose(c.A_blocks.numpy(),
                               np.asarray(ref_c.A_blocks), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(c.b_blocks.numpy(),
                               np.asarray(ref_c.b_blocks), rtol=0,
                               atol=1e-12)
    # kappa(C^T C) = kappa(X): the preconditioned system has the APC rate
    lmin, lmax = spectral.ata_extremes(c)
    assert lmax / lmin == pytest.approx(
        spectral.kappa(spectral.x_matrix(sys_)), rel=1e-8)


@pytest.mark.parametrize("name", ["dgd", "dhbm", "dnag", "madmm", "pdhbm"])
def test_solvers_without_kernel_reject_it(systems, name):
    with pytest.raises(ValueError, match="kernel"):
        solvers.get(name).solve(systems[1], iters=1,
                                plan=solvers.ExecutionPlan(kernel=True))


@pytest.mark.parametrize("name", ["dgd", "madmm", "pdhbm"])
def test_solve_many_rows_match_single_solves(systems, name):
    sys_ = systems[1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    Bm = np.random.default_rng(4).standard_normal((3, sys_.N))
    many = s.solve_many(sys_, Bm, iters=60, **prm)
    for i in range(3):
        one = s.solve(sys_.__class__(sys_.A_blocks,
                                     torch.as_tensor(Bm[i]).reshape(
                                         sys_.m, sys_.p)),
                      iters=60, **prm)
        np.testing.assert_allclose(many.x[i].numpy(), one.x.numpy(),
                                   rtol=1e-12, atol=1e-12)
