"""The port's legacy surfaces against the JAX reference's.

* The loose-kwarg shim of ``solve``/``solve_many`` (``_coerce_plan``):
  a warm start passed as ``warm_state=`` resumes, one
  ``DeprecationWarning`` per call, ``plan=`` mixed with loose kwargs is a
  ``ValueError``, a plan of another type a ``TypeError``, the mesh
  fields (ported, ROADMAP A14) run on a one-rank mesh, and the plan
  fields the port has not ported (redundancy) raise naming their ROADMAP
  item — the local cases of tests/test_execution_plan.py.
* ``ExecutionPlan.replace``, ``Solver.theoretical_rate`` and
  ``core.spectral.apc_rate``.
* The deprecated ``core`` shims (``apc.solve``, ``baselines``,
  ``consensus``, ``precond.preconditioned_dhbm``) on the seeded systems
  of tests/test_baselines.py, tests/test_solvers_registry.py and
  tests/test_system.py, held to those tests' tolerances and to the
  reference's histories.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.core import apc as ref_apc  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import precond as ref_precond  # noqa: E402
from repro.core import spectral as ref_spectral  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.core import apc, baselines, consensus, precond, spectral  # noqa: E402,E501
from repro_torch.data import linsys  # noqa: E402
from repro_torch.solvers.capability import ExecutionPlan  # noqa: E402

torch.set_num_threads(1)

PROJ = ["apc", "consensus", "cimmino"]
ITERS = 80
# the histories of the two packages (tests/test_torch_registry.py)
HIST = dict(rtol=0, atol=1e-10)


def _pair(gen, **kw):
    return (getattr(ref_linsys, gen)(**kw),
            getattr(linsys, gen)(**kw, device="cpu"))


@pytest.fixture(scope="module")
def plan_sys():
    """tests/test_execution_plan.py's system."""
    return _pair("conditioned_gaussian", n=64, m=4, cond=10.0, seed=3)


@pytest.fixture(scope="module")
def base_sys():
    """tests/test_baselines.py's system."""
    return _pair("conditioned_gaussian", n=80, m=4, cond=15.0, seed=3)


def _deprecations(call, **kw):
    """(call(**kw), the DeprecationWarnings naming ExecutionPlan)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = call(**kw)
    return out, [w for w in rec if issubclass(w.category, DeprecationWarning)
                 and "ExecutionPlan" in str(w.message)]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# C3: the loose-kwarg shim
# ---------------------------------------------------------------------------


def test_warm_state_kwarg_resumes_as_the_reference():
    """``solve(iters=5, warm_state=prev.state)`` after a 20-iteration
    solve resumes where the reference resumes (first residual 0.19384,
    not the cold start's 0.44003) with one warning, and its history
    matches the reference's to 1e-6 relative."""
    rs, ps = _pair("conditioned_gaussian", n=64, m=4, cond=20.0, seed=0)
    rprev = ref_solvers.get("apc").solve(rs, iters=20)
    pprev = solvers.get("apc").solve(ps, iters=20)
    r, rdep = _deprecations(ref_solvers.get("apc").solve, sys=rs, iters=5,
                            warm_state=rprev.state)
    p, pdep = _deprecations(solvers.get("apc").solve, sys=ps, iters=5,
                            warm_state=pprev.state)
    assert len(pdep) == len(rdep) == 1
    got, want = _np(p.residuals), _np(r.residuals)
    assert got[0] == pytest.approx(0.19384, abs=5e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert "warm_state" not in p.params
    cold = solvers.get("apc").solve(ps, iters=5)
    assert float(cold.residuals[0]) == pytest.approx(0.44003, abs=5e-6)


@pytest.mark.parametrize("combo", ["local", "kernel"])
@pytest.mark.parametrize("name", PROJ)
def test_plan_bit_identical_to_legacy_kwargs(plan_sys, name, combo):
    """tests/test_execution_plan.py, local and kernel combos: the legacy
    call warns once and is bit-identical to the plan call, and both
    match the reference's."""
    legacy_kw = {} if combo == "local" else {"use_kernel": True}
    rs, ps = plan_sys
    s = solvers.get(name)
    prm = s.resolve_params(ps)
    if legacy_kw:
        r_old, dep = _deprecations(s.solve, sys=ps, iters=ITERS,
                                   **legacy_kw, **prm)
        assert len(dep) == 1
    else:
        r_old = s.solve(ps, iters=ITERS, **prm)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        r_new = s.solve(ps, iters=ITERS,
                        plan=ExecutionPlan(kernel=bool(legacy_kw)), **prm)
    assert torch.equal(r_new.x, r_old.x)
    assert torch.equal(r_new.residuals, r_old.residuals)
    ref = ref_solvers.get(name).solve(
        rs, iters=ITERS, plan=ref_solvers.ExecutionPlan(
            kernel=bool(legacy_kw)), **ref_solvers.get(name).resolve_params(
                rs))
    np.testing.assert_allclose(_np(r_old.residuals), _np(ref.residuals),
                               rtol=1e-6, atol=1e-12)


def test_solve_many_plan_bit_identical(plan_sys):
    _, ps = plan_sys
    s = solvers.get("apc")
    prm = s.resolve_params(ps)
    B = np.linspace(-1.0, 1.0, 3 * ps.N).reshape(3, ps.N)
    r_old, dep = _deprecations(s.solve_many, sys=ps, B=B, iters=ITERS,
                               use_kernel=True, **prm)
    assert len(dep) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        r_new = s.solve_many(ps, B, iters=ITERS,
                             plan=ExecutionPlan(kernel=True), **prm)
    assert torch.equal(r_new.x, r_old.x)
    assert torch.equal(r_new.residuals, r_old.residuals)


def test_warm_start_kwarg_shim_matches_plan(plan_sys):
    _, ps = plan_sys
    s = solvers.get("apc")
    prm = s.resolve_params(ps)
    half = s.solve(ps, iters=40, **prm)
    r_old, dep = _deprecations(s.solve, sys=ps, iters=40,
                               warm_state=half.state, **prm)
    assert len(dep) == 1
    r_new = s.solve(ps, iters=40, plan=ExecutionPlan(warm_state=half.state),
                    **prm)
    assert torch.equal(r_new.x, r_old.x)


def test_one_warning_however_many_kwargs(plan_sys):
    """Four loose kwargs, one warning, as the reference warns per call."""
    rs, ps = plan_sys
    counts = []
    for s, sys_ in ((ref_solvers.get("apc"), rs), (solvers.get("apc"), ps)):
        _, dep = _deprecations(s.solve, sys=sys_, iters=5, use_kernel=True,
                               precision="default", factors=None,
                               store=None)
        counts.append(len(dep))
        msg = str(dep[0].message)
        assert "ExecutionPlan" in msg and "plan=" in msg
    assert counts == [1, 1]


@pytest.mark.parametrize("kw,item", [
    ({"backend": "mesh"}, "A14"),
    ({"mesh": object()}, "A14"),
    ({"worker_axes": ("data",)}, "A14"),
    ({"model_axis": None}, "A14"),
    ({"backend": "mesh", "use_kernel": True, "precision": "default"},
     "A14"),
    ({"redundancy": 2}, "A15"),
    ({"alive_schedule": np.ones((5, 4), bool)}, "A15"),
])
def test_unported_plan_fields_raise_naming_their_item(plan_sys, kw, item):
    """Every plan field the shim once refused is ported now.  The mesh
    kwargs (A14) run on a one-rank mesh with backend="mesh" (a mesh object
    with the local backend is the reference's ValueError).  redundancy=
    and alive_schedule= (A15) run solve's redundant path, held to the
    reference's solve with the same kwargs (x rtol 1e-8 / atol 1e-10,
    history rtol 1e-6 / atol 1e-12), and solve_many raises the
    reference's ValueError naming it.  Each after the one warning."""
    rs, ps = plan_sys
    s, ref = solvers.get("apc"), ref_solvers.get("apc")
    prm = ref.resolve_params(rs)
    if item == "A15":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r_ref = ref.solve(rs, iters=5, **kw, **prm)
            with pytest.raises(ValueError, match="solve_many"):
                ref.solve_many(rs, np.ones((2, rs.N)), iters=5, **kw)
    for call, args in ((s.solve, {}), (s.solve_many,
                                       {"B": np.ones((2, ps.N))})):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if item == "A15" and call == s.solve:
                r = call(ps, iters=5, **kw, **prm)
                np.testing.assert_allclose(r.x.numpy(), np.asarray(r_ref.x),
                                           rtol=1e-8, atol=1e-10)
                np.testing.assert_allclose(r.residuals.numpy(),
                                           np.asarray(r_ref.residuals),
                                           rtol=1e-6, atol=1e-12)
            elif item == "A15":
                with pytest.raises(ValueError, match="solve_many"):
                    call(ps, iters=5, **args, **kw)
            elif "mesh" in kw:
                with pytest.raises(ValueError, match="backend='mesh'"):
                    call(ps, iters=5, **args, **kw)
            else:
                r = call(ps, iters=5, **args, **{"backend": "mesh", **kw})
                assert r.residuals.shape[-1] == 5
                assert torch.isfinite(r.residuals).all()
        assert len([w for w in rec
                    if issubclass(w.category, DeprecationWarning)]) == 1


def test_plan_plus_legacy_kwargs_is_an_error(plan_sys):
    rs, ps = plan_sys
    for pkg, sys_, Plan in ((ref_solvers, rs, ref_solvers.ExecutionPlan),
                            (solvers, ps, ExecutionPlan)):
        s = pkg.get("apc")
        with pytest.raises(ValueError, match="both plan="):
            s.solve(sys_, iters=5, plan=Plan(), backend="mesh")
        with pytest.raises(ValueError, match="both plan="):
            s.solve_many(sys_, np.ones((2, sys_.N)), iters=5, plan=Plan(),
                         use_kernel=True)


def test_plan_type_checked(plan_sys):
    rs, ps = plan_sys
    for s, sys_ in ((ref_solvers.get("apc"), rs), (solvers.get("apc"), ps)):
        with pytest.raises(TypeError, match="ExecutionPlan"):
            s.solve(sys_, iters=5, plan={"kernel": True})


# ---------------------------------------------------------------------------
# C2: replace, theoretical_rate, apc_rate
# ---------------------------------------------------------------------------


def test_plan_replace():
    base = ExecutionPlan(precision="mixed")
    new = base.replace(kernel=True)
    assert new.kernel and new.precision == "mixed" and not base.kernel
    assert new.signature() == ref_solvers.ExecutionPlan(
        kernel=True, precision="mixed").signature()
    with pytest.raises(ValueError):
        base.replace(redundancy=0)


@pytest.mark.parametrize("name", ["apc", "cimmino", "consensus", "dgd",
                                  "dhbm", "dnag", "madmm", "pdhbm"])
def test_theoretical_rate_matches_the_reference(name):
    rs, ps = _pair("conditioned_gaussian", n=64, m=4, cond=20.0, seed=0)
    want = ref_solvers.get(name).theoretical_rate(rs)
    got = solvers.get(name).theoretical_rate(ps)
    if want is None:
        assert got is None
        return
    assert got == pytest.approx(want, rel=1e-12)
    if name == "apc":
        assert got == pytest.approx(0.869100, abs=5e-7)
        assert got == pytest.approx(
            ref_spectral.rates_summary(rs)["APC"], rel=1e-12)


def test_apc_rate():
    for mu in ((0.02, 0.9), (0.3, 0.31), (1e-4, 1.0)):
        assert spectral.apc_rate(*mu) == pytest.approx(
            ref_spectral.apc_rate(*mu), rel=1e-15)
        assert spectral.apc_rate(*mu) == spectral.apc_optimal(*mu).rho


# ---------------------------------------------------------------------------
# A18: the deprecated core shims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,tol", [
    ("dgd", 1e-3), ("dnag", 1e-6), ("dhbm", 1e-6), ("madmm", 5e-2),
    ("cimmino", 1e-3), ("consensus", 1e-3)])
def test_method_converges(base_sys, method, tol):
    """tests/test_baselines.py::test_method_converges, both packages."""
    rs, ps = base_sys
    got = getattr(baselines, method)(ps, iters=2500)
    want = getattr(ref_baselines, method)(rs, iters=2500)
    assert float(got.errors[-1]) < tol, got.name
    np.testing.assert_allclose(_np(got.errors), _np(want.errors), **HIST)
    assert got.name == want.name == method


def test_table1_rate_ordering(base_sys):
    rs, ps = base_sys
    s = spectral.rates_summary(ps)
    assert s["APC"] <= s["D-HBM"] + 1e-12
    assert s["D-HBM"] <= s["D-NAG"] + 1e-12
    assert s["D-NAG"] <= s["DGD"] + 1e-12
    assert s["APC"] <= s["B-Cimmino"] + 1e-12
    assert s["APC"] <= s["Consensus"] + 1e-12
    want = ref_spectral.rates_summary(rs)
    for key, v in want.items():
        assert s[key] == pytest.approx(v, rel=1e-9), key


def test_empirical_ordering(base_sys):
    """After a fixed budget, APC's error <= the gradient family's; the
    shims' histories are the reference's."""
    rs, ps = base_sys
    iters = 400
    e_apc = apc.solve(ps, iters=iters)
    np.testing.assert_allclose(_np(e_apc.errors),
                               _np(ref_apc.solve(rs, iters=iters).errors),
                               **HIST)
    for fn in (baselines.dgd, baselines.dnag, baselines.dhbm,
               baselines.cimmino, baselines.consensus):
        e = float(fn(ps, iters=iters).errors[-1])
        assert float(e_apc.errors[-1]) <= e * 1.5 + 1e-12


def test_preconditioned_dhbm_matches_apc_rate(base_sys):
    rs, ps = base_sys
    pre = precond.precondition(ps)
    lmin, lmax = spectral.ata_extremes(pre)
    mu_min, mu_max = spectral.mu_extremes(spectral.x_matrix(ps))
    assert lmax / lmin == pytest.approx(mu_max / mu_min, rel=1e-6)
    hist = precond.preconditioned_dhbm(ps, iters=500)
    assert float(hist.errors[-1]) < 1e-8
    want = ref_precond.preconditioned_dhbm(rs, iters=500)
    np.testing.assert_allclose(_np(hist.errors), _np(want.errors), **HIST)


@pytest.mark.parametrize("name,legacy", [
    ("apc", lambda s, it: apc.solve(s, iters=it)),
    ("dgd", lambda s, it: baselines.dgd(s, iters=it)),
    ("dnag", lambda s, it: baselines.dnag(s, iters=it)),
    ("dhbm", lambda s, it: baselines.dhbm(s, iters=it)),
    ("madmm", lambda s, it: baselines.madmm(s, iters=it)),
    ("cimmino", lambda s, it: baselines.cimmino(s, iters=it)),
    ("consensus", lambda s, it: baselines.consensus(s, iters=it)),
    ("pdhbm", lambda s, it: precond.preconditioned_dhbm(s, iters=it)),
])
def test_agrees_with_registry(name, legacy):
    """tests/test_solvers_registry.py::test_agrees_with_legacy_entry_point:
    each shim routes every kwarg to the registry unchanged, silent as the
    reference's shims are."""
    _, ps = _pair("conditioned_gaussian", n=64, m=4, cond=10.0, seed=0)
    r_new = solvers.get(name).solve(ps, iters=120)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        r_old = legacy(ps, 120)
    assert torch.equal(r_new.x, r_old.x)
    assert torch.equal(r_new.residuals, r_old.residuals)


def test_shim_kwargs_and_aliases(base_sys):
    """Explicit parameters reach the solver; ``History`` and
    ``SolveResult`` are the result type; ``_full_grad`` is the summed
    gradient the reference's returns."""
    rs, ps = base_sys
    nu = 0.3 / ps.m
    got = baselines.cimmino(ps, iters=40, nu=nu)
    want = ref_baselines.cimmino(rs, iters=40, nu=nu)
    assert got.params["nu"] == nu
    np.testing.assert_allclose(_np(got.x), _np(want.x), **HIST)
    assert baselines.History is apc.SolveResult is solvers.SolveResult
    assert sorted(baselines.ALL_METHODS) == sorted(ref_baselines.ALL_METHODS)
    x = np.random.default_rng(0).standard_normal(ps.n)
    g = baselines._full_grad(ps, torch.as_tensor(x))
    np.testing.assert_allclose(
        _np(g), _np(ref_baselines._full_grad(rs, jnp.asarray(x))),
        rtol=1e-12, atol=1e-10)
    with pytest.raises(AttributeError):
        baselines.nope  # noqa: B018


def test_consensus_combinator_reproduces_apc():
    """tests/test_system.py::test_consensus_combinator_reproduces_apc:
    the combinator with the APC local step equals the APC iteration."""
    _, ps = _pair("conditioned_gaussian", n=48, m=4, cond=8.0, seed=2)
    A = ps.A_blocks
    chol = apc._gram_chol(A, 0.0)
    x0 = A.transpose(-1, -2) @ torch.cholesky_solve(
        ps.b_blocks[..., None], chol)
    x0 = x0[..., 0]
    gamma, eta = 1.3, 1.2

    def local_step(ctx, xi, xbar):
        Ai, Li = ctx
        d = xbar - xi
        w = torch.cholesky_solve((Ai @ d)[:, None], Li)[:, 0]
        return xi + gamma * (d - Ai.T @ w)

    xs, xbar = consensus.run_consensus(local_step, x0, x0.mean(dim=0),
                                       eta=eta, rounds=50, context=(A, chol))
    s = apc.APCState(x=x0, xbar=x0.mean(dim=0), t=0)
    for _ in range(50):
        s = apc.apc_step(A, chol, s, gamma, eta)
    np.testing.assert_allclose(_np(xbar), _np(s.xbar), rtol=1e-10,
                               atol=1e-12)
    # a pytree state: the same round on a dict of two copies
    tree, tbar = consensus.consensus_round(
        lambda c, x, xb: {k: local_step(c, v, xb[k]) for k, v in x.items()},
        {"a": x0, "b": x0}, {"a": x0.mean(0), "b": x0.mean(0)}, eta,
        context=(A, chol))
    assert torch.equal(tree["a"], tree["b"])
    assert torch.equal(tbar["a"], tbar["b"])
