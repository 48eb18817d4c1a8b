"""Least-squares mode in the port against the JAX reference.

An inconsistent system (``tall_gaussian(noise>0)``) runs through the
same ``solve``/``solve_many`` entry points as a square one: the
LS-capable solvers (Cimmino and the gradient family) record the
optimality residual ‖ls_moment(x)‖/‖ls_moment(0)‖, take their errors
against ``ls_reference`` and converge to numpy's ``lstsq`` (the gradient
family) or to the Gram-weighted optimum (Cimmino) to 1e-6 relative, as
tests/test_modes.py holds the reference; the square-only solvers refuse
such a system at dispatch.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.launch import solve as ref_cli  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.launch import solve as cli  # noqa: E402

torch.set_num_threads(1)

LS = dict(N=240, n=120, m=4, seed=0, noise=0.05)    # tests/test_modes.py
LS_OK = ["cimmino", "dgd", "dnag", "dhbm"]
SQUARE_ONLY = ["apc", "consensus", "madmm", "pdhbm"]
ITERS = 800
HIST = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def ls_sys():
    return (ref_linsys.tall_gaussian(**LS),
            linsys.tall_gaussian(**LS, device="cpu"))


@pytest.fixture(scope="module")
def ls_solves(ls_sys):
    """name -> (port, reference) 800-iteration LS solves, once each."""
    memo = {}

    def get(name):
        if name not in memo:
            ref_sys, sys_ = ls_sys
            prm = {k: float(v) for k, v in
                   ref_solvers.get(name).resolve_params(ref_sys).items()}
            memo[name] = (solvers.get(name).solve(sys_, iters=ITERS, **prm),
                          ref_solvers.get(name).solve(ref_sys, iters=ITERS,
                                                      **prm))
        return memo[name]
    return get


def _rel_err(x, ref):
    x, ref = (np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
              for t in (x, ref))
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_mode_auto_resolution():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((48, 48))
    assert partition(A, A @ rng.standard_normal(48), 4,
                     device="cpu").mode == "square"
    At = rng.standard_normal((96, 48))
    assert partition(At, rng.standard_normal(96), 4,
                     device="cpu").mode == "least_squares"
    assert partition(At, rng.standard_normal(96), 4, mode="square",
                     device="cpu").mode == "square"
    with pytest.raises(ValueError, match="mode"):
        partition(A, A[:, 0], 4, mode="banana", device="cpu")


def test_tall_gaussian_noise_is_bit_identical_and_inconsistent(ls_sys):
    ref_sys, sys_ = ls_sys
    for field in ("A_blocks", "b_blocks", "x_true"):
        assert np.array_equal(np.asarray(getattr(ref_sys, field)),
                              getattr(sys_, field).numpy()), field
    assert sys_.mode == ref_sys.mode == "least_squares"
    A, b = (t.numpy() for t in sys_.dense())
    x_ls, residual_ss, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert residual_ss > 0                    # b truly out of range(A)
    assert np.allclose(sys_.x_true.numpy(), x_ls)
    quiet = linsys.tall_gaussian(N=240, n=120, m=4, seed=0, device="cpu")
    assert quiet.mode == "square"             # noise=0: consistent
    assert torch.equal(quiet.A_blocks, sys_.A_blocks)


@pytest.mark.parametrize("name", LS_OK)
def test_ls_reference_matches_reference(ls_sys, name):
    ref_sys, sys_ = ls_sys
    got = solvers.get(name).ls_reference(sys_)
    want = np.asarray(ref_solvers.get(name).ls_reference(ref_sys))
    assert got.dtype == torch.float64 and got.shape == (sys_.n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", LS_OK)
def test_ls_solution_matches_solver_reference(ls_sys, ls_solves, name):
    """tests/test_modes.py::test_ls_solution_matches_solver_reference,
    and the histories against the reference's."""
    sys_ = ls_sys[1]
    r, r_ref = ls_solves(name)
    assert _rel_err(r.x, solvers.get(name).ls_reference(sys_)) < 1e-6
    assert float(r.residuals[-1]) < 1e-8      # LS optimality moment -> 0
    assert r.errors is not None
    np.testing.assert_allclose(r.residuals.numpy(),
                               np.asarray(r_ref.residuals), **HIST)
    np.testing.assert_allclose(r.errors.numpy(), np.asarray(r_ref.errors),
                               **HIST)
    assert r.iters_to_tol == r_ref.iters_to_tol


@pytest.mark.parametrize("name", ["dgd", "dnag", "dhbm"])
def test_gradient_family_ls_matches_plain_lstsq(ls_sys, ls_solves, name):
    A, b = (t.numpy() for t in ls_sys[1].dense())
    x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert _rel_err(ls_solves(name)[0].x, x_ls) < 1e-6


def test_cimmino_ls_reference_is_gram_weighted(ls_sys, ls_solves):
    """On an inconsistent system Cimmino's fixed point is the
    G⁻¹-weighted optimum, a different minimizer than plain lstsq."""
    sys_ = ls_sys[1]
    A, b = (t.numpy() for t in sys_.dense())
    x_plain, *_ = np.linalg.lstsq(A, b, rcond=None)
    ref = solvers.get("cimmino").ls_reference(sys_)
    assert _rel_err(ref, x_plain) > 1e-3
    assert _rel_err(ls_solves("cimmino")[0].x, ref) < 1e-6


def test_ls_kernel_cimmino_has_no_fused_residual(ls_sys, ls_solves,
                                                 monkeypatch):
    """In LS mode the kernel path runs (plain versions here) but the
    history is the optimality residual: the gather's u is not taken as
    the residual, so ``step_residual`` is never called."""
    sys_ = ls_sys[1]
    s = solvers.get("cimmino")

    def no_fused(*a, **k):
        raise AssertionError("fused residual used in least-squares mode")
    monkeypatch.setattr(type(s), "step_residual", no_fused)
    prm = s.resolve_params(sys_)
    rk = s.solve(sys_, iters=ITERS, plan=solvers.ExecutionPlan(kernel=True),
                 **prm)
    ru = ls_solves("cimmino")[0]
    np.testing.assert_allclose(rk.residuals.numpy(), ru.residuals.numpy(),
                               rtol=1e-6, atol=1e-12)
    assert _rel_err(rk.x, s.ls_reference(sys_)) < 1e-6


@pytest.mark.parametrize("name", ["cimmino", "dgd"])
def test_consistent_tall_system_reaches_x_true(name):
    sys_ = linsys.tall_gaussian(N=240, n=120, m=4, seed=1, device="cpu")
    s = solvers.get(name)
    r = s.solve(sys_, iters=ITERS, **s.resolve_params(sys_))
    assert _rel_err(r.x, sys_.x_true) < 1e-8


@pytest.mark.parametrize("name,kernel", [("dgd", False), ("cimmino", True)])
def test_ls_solve_many_batches_the_optimality_residual(ls_sys, name,
                                                       kernel):
    ref_sys, sys_ = ls_sys
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    B = np.random.default_rng(2).standard_normal((3, sys_.N))
    rm = s.solve_many(sys_, B, iters=ITERS,
                      plan=solvers.ExecutionPlan(kernel=kernel), **prm)
    assert rm.residuals.shape == (3, ITERS)
    if name == "dgd":
        A = sys_.dense()[0].numpy()
        rr = ref_solvers.get(name).solve_many(ref_sys, B, iters=ITERS,
                                              **prm)
        np.testing.assert_allclose(rm.residuals.numpy(),
                                   np.asarray(rr.residuals), **HIST)
    for k in range(3):
        row = partition(sys_.A_blocks.reshape(sys_.N, sys_.n),
                        torch.as_tensor(B[k]), sys_.m)
        assert row.mode == "least_squares"
        ref_x = (np.linalg.lstsq(A, B[k], rcond=None)[0] if name == "dgd"
                 else s.ls_reference(row))
        assert _rel_err(rm.x[k], ref_x) < 1e-6
        assert float(rm.residuals[k, -1]) < 1e-8


@pytest.mark.parametrize("name", SQUARE_ONLY)
def test_square_only_solver_rejects_least_squares(ls_sys, name):
    sys_ = ls_sys[1]
    s = solvers.get(name)
    with pytest.raises(solvers.CapabilityError,
                       match="least_squares") as ei:
        s.solve(sys_, iters=5)
    assert f"'{name}'" in str(ei.value) and "supports=" in str(ei.value)
    with pytest.raises(solvers.CapabilityError, match="solve_many"):
        s.solve_many(sys_, np.zeros((2, sys_.N)), iters=5)


@pytest.mark.parametrize("method", ["cimmino", "dgd"])
def test_cli_runs_the_least_squares_problem(method):
    argv = ["--problem", "tall_noisy", "--workers", "4", "--iters", "40",
            "--method", method]
    outs = []
    for main, extra in ((ref_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]
