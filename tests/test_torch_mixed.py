"""``precision="mixed"`` in the port against the JAX reference.

Under ``precision="mixed"`` the projection solvers store the kernels'
matrix streams (A and B, or a sparse system's vals and Bvals) in
bfloat16 while x, the accumulation and the Cholesky factors stay in the
working dtype (float64 here, as the reference's tests run with x64 on).
The port is held to the reference's mixed run at the parity tolerances
of the default runs (tests/test_torch_apc.py, test_torch_cimmino.py,
test_torch_sparse.py): the bf16 rounding is the same on both sides, so
nothing looser is needed.  The reference's mixed factors cross through
``interop`` by their bits, since the port's own B may round to a
different bf16 in the last place.  The reference's engine is pinned to
its fused kernels (``REPRO_KERNEL_ENGINE=fused``), run in interpret
mode, as the port launches its kernels at every batch size; here the
port's kernel ops run their plain versions.  The CUDA kernels' mixed
forms are held against the same plain versions on the card by
chip_smoke.py.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core import blockops  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.solvers.projection import ProjFactors  # noqa: E402

torch.set_num_threads(1)

ITERS = 40                 # tests/test_kernel_corners.py
# tests/test_kernel_corners.py: the bf16 stream's envelope of the default
# run
MIXED_TOL = dict(rtol=0.5, atol=5e-2)
# the parity tolerances of the default runs: tests/test_torch_apc.py HIST
# (APC, consensus), tests/test_torch_cimmino.py HIST, and
# tests/test_torch_sparse.py HIST_TOL / X_TOL on sparse systems
HIST = {"apc": dict(rtol=0, atol=1e-9), "consensus": dict(rtol=0, atol=1e-9),
        "cimmino": dict(rtol=0, atol=1e-10)}
SPARSE_HIST = dict(rtol=1e-6, atol=1e-12)
SPARSE_X = dict(rtol=1e-8, atol=1e-10)
TOL = {np.float32: 2e-5, np.float64: 1e-12}     # tests/test_kernels.py
KERNEL = ["apc", "consensus", "cimmino"]
M, GAMMA = 3, 0.83
REF_MIXED = ref_solvers.ExecutionPlan(kernel=True, precision="mixed")


@pytest.fixture(autouse=True)
def fused(monkeypatch):
    monkeypatch.setenv(ref_ops.ENGINE_ENV, "fused")


@pytest.fixture(scope="module")
def systems():
    """(reference, port) pairs: tests/test_kernel_corners.py's dense and
    sparse systems of the mixed-precision test."""
    dense = dict(n=192, m=4, cond=10.0, seed=0)
    band = dict(n=192, m=4, bandwidth=6, seed=0)
    return {
        "dense": (ref_linsys.conditioned_gaussian(**dense),
                  linsys.conditioned_gaussian(**dense, device="cpu")),
        "sparse": (ref_linsys.banded_system(**band),
                   linsys.banded_system(**band, device="cpu")),
    }


def _ref_mixed_factors(s, ref_sys, prm):
    """The reference's factors as its mixed solve builds them, carried
    into the port."""
    f = s.cast_factors(s.kernel_factors(s.prepare(ref_sys.A_op, prm)),
                       "mixed")
    return interop.from_numpy(ProjFactors, *f, device="cpu")


def _mixed(**kw):
    return solvers.ExecutionPlan(kernel=True, precision="mixed", **kw)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", KERNEL)
@pytest.mark.parametrize("structure", ["dense", "sparse"])
def test_mixed_solve_matches_reference(systems, structure, name):
    ref_sys, sys_ = systems[structure]
    ref = ref_solvers.get(name)
    prm = ref.resolve_params(ref_sys)
    r_ref = ref.solve(ref_sys, iters=ITERS, plan=REF_MIXED, **prm)
    facs = _ref_mixed_factors(ref, ref_sys, prm)
    assert blockops.block_dtype(facs.A) == facs.B.dtype == torch.bfloat16
    r = solvers.get(name).solve(sys_, iters=ITERS,
                                plan=_mixed(factors=facs), **prm)
    assert r.x.dtype == torch.float64
    if structure == "dense":
        hist = HIST[name]
        x_err = np.linalg.norm(_np(r.x) - _np(r_ref.x)) / np.linalg.norm(
            _np(r_ref.x))
        assert x_err < 1e-9, x_err
    else:
        hist = SPARSE_HIST
        np.testing.assert_allclose(_np(r.x), _np(r_ref.x), **SPARSE_X)
    np.testing.assert_allclose(_np(r.residuals), _np(r_ref.residuals),
                               **hist)
    np.testing.assert_allclose(_np(r.errors), _np(r_ref.errors), **hist)
    assert r.iters_to_tol == r_ref.iters_to_tol


@pytest.mark.parametrize("name", KERNEL)
@pytest.mark.parametrize("structure", ["dense", "sparse"])
def test_mixed_solve_stays_in_the_bf16_envelope(systems, structure, name):
    """The port's own mixed run, its factors cast by the port, against its
    default kernel run (tests/test_kernel_corners.py's envelope); the
    mixed history is that of the default run on bf16-rounded A and B."""
    _, sys_ = systems[structure]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    r_m = s.solve(sys_, iters=ITERS, plan=_mixed(), **prm)
    r = s.solve(sys_, iters=ITERS, plan=solvers.ExecutionPlan(kernel=True),
                **prm)
    assert torch.isfinite(r_m.residuals).all()
    np.testing.assert_allclose(_np(r_m.residuals), _np(r.residuals),
                               **MIXED_TOL)
    # the upcast twin: the default solve on the bf16-rounded factors
    f = s.cast_factors(s.kernel_factors(s.prepare(sys_.A_op, prm)),
                       "mixed")
    A = f.A._replace(vals=f.A.vals.double()) if blockops.is_sparse(f.A) \
        else f.A.double()
    twin = s.solve(sys_, iters=ITERS, plan=solvers.ExecutionPlan(
        kernel=True, factors=ProjFactors(A=A, chol=f.chol, B=f.B.double())),
        **prm)
    np.testing.assert_allclose(_np(r_m.residuals), _np(twin.residuals),
                               rtol=0, atol=1e-12)


def test_mixed_solve_many_matches_reference(systems):
    """The local half of tests/test_kernel_corners.py's solve_many/mesh
    test: k = 3 right-hand sides on the banded system."""
    ref_sys, sys_ = systems["sparse"]
    ref = ref_solvers.get("apc")
    prm = ref.resolve_params(ref_sys)
    B = np.random.default_rng(2).standard_normal((3, ref_sys.N))
    r_ref = ref.solve_many(ref_sys, B, iters=30, plan=REF_MIXED, **prm)
    facs = _ref_mixed_factors(ref, ref_sys, prm)
    r = solvers.get("apc").solve_many(sys_, B, iters=30,
                                      plan=_mixed(factors=facs), **prm)
    assert r.residuals.shape == (3, 30)
    assert torch.isfinite(r.residuals).all()
    np.testing.assert_allclose(_np(r.residuals), _np(r_ref.residuals),
                               **SPARSE_HIST)
    np.testing.assert_allclose(_np(r.x), _np(r_ref.x), **SPARSE_X)


def _dense_inputs(p, n, k, dtype, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, p, n))
    G = np.einsum("mpn,mqn->mpq", A, A)
    B = np.linalg.solve(G, A).transpose(0, 2, 1)            # (m, n, p)
    X = rng.standard_normal((M, n) if k == 1 else (M, k, n))
    xb = rng.standard_normal((n,) if k == 1 else (k, n))
    b = rng.standard_normal((M, p) if k == 1 else (M, k, p))
    return A, B, X.astype(dtype), xb.astype(dtype), b.astype(dtype)


def _bf16(a):
    """(jax, torch) bfloat16 copies of a float64 array, bit-identical."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, interop.from_numpy(ProjFactors, np.asarray(j), None, None,
                                 device="cpu").A


def _err(got, want):
    got = _np(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1.0)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p,n", [(8, 128), (7, 130)])
def test_mixed_dense_ops_match_reference(p, n, dtype, k):
    """The dense kernel ops on a bf16 A/B and float64 or float32 x: the
    port's plain versions against the reference's worker-vmapped Pallas
    kernels in interpret mode, at the compute dtype's tolerance (the
    widening of bf16 is exact on both sides)."""
    A, B, X, Xb, b = _dense_inputs(p, n, k, dtype)
    (jA, tA), (jB, tB) = _bf16(A), _bf16(B)
    jX, jXb, jb = (jnp.asarray(a) for a in (X, Xb, b))
    tX, tXb, tb = (torch.as_tensor(a) for a in (X, Xb, b))
    u_ref = jax.vmap(ref_ops.proj_gather, in_axes=(0, 0, None))(jA, jX, jXb)
    y_ref = jax.vmap(ref_ops.proj_scatter, in_axes=(0, 0, None, 0, None))(
        jB, jX, jXb, u_ref, GAMMA)
    c_ref = jax.vmap(ref_ops.cimmino_gather, in_axes=(0, None))(jA, jXb)
    r_ref = jax.vmap(ref_ops.cimmino_scatter)(jB, jb - c_ref)
    before = ops.launch_counts()
    u = ops.proj_gather(tA, tX, tXb)
    y = ops.proj_scatter(tB, tX, tXb, torch.as_tensor(np.array(u_ref)),
                         GAMMA)
    c = ops.cimmino_gather(tA, tXb)
    r = ops.cimmino_scatter(tB, tb - torch.as_tensor(np.array(c_ref)))
    assert ops.launch_counts() == before     # CPU tensors never launch
    for got, want in ((u, u_ref), (y, y_ref), (c, c_ref), (r, r_ref)):
        assert got.dtype == tX.dtype
        assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mixed_sparse_ops_match_reference(systems, k, dtype):
    """Both sparse ops on bf16 vals/Bvals against the reference's Pallas
    ops in interpret mode, on the banded system's compressed support."""
    ref_sys, _ = systems["sparse"]
    ref = ref_solvers.get("apc")
    f = ref.cast_factors(ref.kernel_factors(ref.prepare(ref_sys.A_op, {})),
                         "mixed")
    t = interop.from_numpy(ProjFactors, *f, device="cpu")
    m, p, w = t.A.vals.shape
    n = ref_sys.n
    rng = np.random.default_rng(k)
    shape = lambda *s: s if k == 1 else s[:-1] + (k,) + s[-1:]  # noqa: E731
    X = rng.standard_normal(shape(m, n)).astype(dtype)
    Xb = rng.standard_normal((n,) if k == 1 else (k, n)).astype(dtype)
    b = rng.standard_normal(shape(m, p)).astype(dtype)
    jX, jXb, jb = (jnp.asarray(a) for a in (X, Xb, b))
    cols32 = jnp.asarray(np.asarray(f.A.cols), jnp.int32)
    y_ref, u_ref = jax.vmap(ref_ops.sparse_proj_update,
                            (0, 0, 0, 0, None, None))(
        f.A.vals, cols32, f.B, jX, jXb, GAMMA)
    r_ref, c_ref = jax.vmap(ref_ops.sparse_cimmino_update,
                            (0, 0, 0, 0, None))(f.A.vals, cols32, f.B, jb,
                                                jXb)
    tX, tXb, tb = (torch.as_tensor(a) for a in (X, Xb, b))
    y, u = ops.sparse_proj_update(t.A.vals, t.A.cols, t.B, tX, tXb, GAMMA)
    r, c = ops.sparse_cimmino_update(t.A.vals, t.A.cols, t.B, tb, tXb)
    for got, want in ((y, y_ref), (u, u_ref), (r, r_ref), (c, c_ref)):
        assert got.dtype == tX.dtype
        assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("matrix,operands,ok", [
    (torch.bfloat16, torch.float64, True),
    (torch.bfloat16, torch.float32, True),
    (torch.float64, torch.float64, True),
    (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, False),   # the all-bf16 form: B1b
    (torch.float32, torch.float64, False),
    (torch.float64, torch.float32, False),
    (torch.bfloat16, torch.float16, False),
])
def test_ops_admit_exactly_the_kernels_dtype_pairs(matrix, operands, ok):
    """The ops take the four pairs the CUDA kernels have entries for and
    refuse every other before a plain version (or a kernel) runs."""
    A = torch.ones((2, 3, 16), dtype=matrix)
    X = torch.ones((2, 16), dtype=operands)
    Xb = torch.ones(16, dtype=operands)
    if ok:
        assert not ops._on_cuda("proj_gather", (A,), X, Xb)
        assert ops.proj_gather(A, X, Xb).dtype == operands
        assert set(bp.PAIRS) >= {(matrix, operands)}
    else:
        with pytest.raises(TypeError, match="dtypes"):
            ops.proj_gather(A, X, Xb)
        assert (matrix, operands) not in bp.PAIRS


def _rejection_system(structure):
    if structure == "dense":
        return (ref_linsys.standard_gaussian(n=96, m=4, seed=0),
                linsys.standard_gaussian(n=96, m=4, seed=0, device="cpu"))
    band = dict(n=96, m=4, bandwidth=4, seed=0)
    return (ref_linsys.banded_system(**band),
            linsys.banded_system(**band, device="cpu"))


@pytest.mark.parametrize("name,structure,kernel,precision,match", [
    ("apc", "dense", False, "mixed", "use_kernel"),
    ("apc", "dense", True, "f8", "unknown precision"),
    ("dgd", "dense", True, "mixed", "use_kernel"),
    # the sparse downgrade comes first, then the precision check
    ("dgd", "sparse", True, "mixed", "requires use_kernel=True"),
])
def test_precision_rejections(name, structure, kernel, precision, match):
    """tests/test_kernel_corners.py::test_precision_rejections, and the
    sparse dgd case: the port raises where the reference raises."""
    ref_sys, sys_ = _rejection_system(structure)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(ValueError, match=match):
            ref_solvers.get(name).solve(
                ref_sys, iters=2, plan=ref_solvers.ExecutionPlan(
                    kernel=kernel, precision=precision))
    plan = solvers.ExecutionPlan(kernel=kernel, precision=precision)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with pytest.raises(ValueError, match=match):
            solvers.get(name).solve(sys_, iters=2, plan=plan)
    downgraded = structure == "sparse" and name == "dgd"
    assert any(issubclass(w.category, RuntimeWarning)
               for w in seen) == downgraded


@pytest.mark.parametrize("name", ["apc", "cimmino"])
@pytest.mark.parametrize("structure", ["dense", "sparse"])
def test_cast_factors_is_idempotent(systems, structure, name):
    _, sys_ = systems[structure]
    s = solvers.get(name)
    f = s.kernel_factors(s.prepare(sys_.A_op, {}))
    assert s.cast_factors(f, "default") is f
    once = s.cast_factors(f, "mixed")
    twice = s.cast_factors(once, "mixed")
    assert blockops.block_dtype(once.A) == once.B.dtype == torch.bfloat16
    assert once.chol.dtype == torch.float64 and once.chol is f.chol
    V = (lambda a: a.vals) if structure == "sparse" else (lambda a: a)
    assert torch.equal(V(twice.A), V(once.A))
    assert torch.equal(twice.B, once.B)
    assert torch.equal(V(once.A), V(f.A).to(torch.bfloat16))
    if structure == "sparse":
        assert once.A.cols is f.A.cols


def test_interop_carries_bfloat16_by_its_bits():
    """np.asarray of a JAX bf16 array has the ml_dtypes dtype, which
    torch.as_tensor refuses; interop carries its 16-bit patterns.  The
    f64 -> bf16 casts of the two packages agree bit for bit."""
    x = np.random.default_rng(0).standard_normal((4, 5, 50))
    j = jnp.asarray(x).astype(jnp.bfloat16)
    arr = np.asarray(j)
    assert arr.dtype.name == "bfloat16"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # not writable
        with pytest.raises(TypeError):
            torch.as_tensor(arr)
    f = interop.from_numpy(ProjFactors, arr, np.ones((4, 5, 5)), arr,
                           device="cpu")
    assert f.A.dtype == f.B.dtype == torch.bfloat16
    assert f.chol.dtype == torch.float64
    np.testing.assert_array_equal(f.A.view(torch.int16).numpy(),
                                  arr.view(np.int16))
    np.testing.assert_array_equal(
        torch.as_tensor(x).to(torch.bfloat16).view(torch.int16).numpy(),
        arr.view(np.int16))
    sys_ = interop.system_from_numpy(arr, np.ones((4, 5)), device="cpu")
    assert sys_.A_blocks.dtype == torch.bfloat16


@pytest.mark.parametrize("matrix,operands,n,stride,want", [
    # X rows 10 float64 apart (80 bytes): aligned, though 10 bf16
    # elements (20 bytes) would not be
    (torch.bfloat16, torch.float64, 8, 10, "ring"),
    # X rows 12 float32 apart (48 bytes)
    (torch.bfloat16, torch.float32, 8, 12, "ring"),
    # X rows 9 float64 apart (72 bytes): not a 16-byte multiple
    (torch.bfloat16, torch.float64, 8, 9, "row_dot"),
    # the bf16 matrix rows: 12 elements are 24 bytes
    (torch.bfloat16, torch.float64, 12, 12, "row_dot"),
    (torch.float64, torch.float64, 8, 9, "row_dot"),
    (torch.float64, torch.float64, 8, 10, "ring"),
])
def test_gather_instance_counts_each_operands_itemsize(matrix, operands, n,
                                                       stride, want):
    """Every stride counts in its own tensor's element size: a bf16
    matrix beside float64 or float32 operands."""
    m, p, k = 2, 3, 4
    A = torch.zeros((m, p, n), dtype=matrix)
    X = torch.zeros((m, k, stride), dtype=operands)[..., :n]
    Xb = torch.zeros((k, stride), dtype=operands)[:, :n]
    assert bp.gather_instance(A, X, Xb) == want
    assert bp.gather_instance(A, Xb) == want
