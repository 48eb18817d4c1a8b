"""The port's kernel ops against the JAX reference's Pallas ops.

On the CPU the port's ``proj_gather``/``proj_scatter``/``block_projection``
run their plain PyTorch versions; the reference's ops run their Pallas
kernels in interpret mode, as tests/test_kernels.py runs them.  Same
seeded inputs, the reference's tolerances (tests/test_kernels.py TOL,
relative to max|ref| + 1).  The CUDA kernels themselves are held against
the same plain versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

TOL = {np.float32: 2e-5, np.float64: 1e-12}
GAMMA = 0.83
M = 3


def _inputs(p, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, p, n))
    G = np.einsum("mpn,mqn->mpq", A, A)
    B = np.linalg.solve(G, A).transpose(0, 2, 1)            # (m, n, p)
    xs = (M, n) if k == 1 else (M, k, n)
    X = rng.standard_normal(xs)
    Xb = rng.standard_normal(xs[1:])
    return [a.astype(dtype) for a in (A, B, X, Xb)]


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1.0)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p,n", [(8, 128), (7, 130), (1, 128), (16, 512)])
def test_ops_match_reference(p, n, dtype, k):
    """m = 3 workers against the reference's worker-vmapped Pallas ops
    and its jnp oracles; m = 1 is the first worker alone."""
    A, B, X, Xb = _inputs(p, n, k, dtype)
    J = [jnp.asarray(a) for a in (A, B, X, Xb)]
    u_ref = jax.vmap(ref_ops.proj_gather, in_axes=(0, 0, None))(
        J[0], J[2], J[3])
    y_ref = jax.vmap(ref_ops.proj_scatter, in_axes=(0, 0, None, 0, None))(
        J[1], J[2], J[3], u_ref, GAMMA)
    z_ref = ref_ops.block_projection_batched(J[0], J[1], J[2], J[3], GAMMA)
    u_or = jax.vmap(ref_ref.apc_gather_ref, in_axes=(0, 0, None))(
        J[0], J[2], J[3])
    z_or = jax.vmap(ref_ref.block_projection_ref,
                    in_axes=(0, 0, 0, None, None))(J[0], J[1], J[2], J[3],
                                                   GAMMA)
    tol = TOL[dtype]
    before = ops.launch_counts()
    for m in (M, 1):
        T = [torch.as_tensor(a[:m]) for a in (A, B, X)] + [
            torch.as_tensor(Xb)]
        u = ops.proj_gather(T[0], T[2], T[3])
        # the scatter consumes the reference's u, as its test does
        y = ops.proj_scatter(T[1], T[2], T[3],
                             torch.as_tensor(np.array(u_ref)[:m]), GAMMA)
        z = ops.block_projection(T[0], T[1], T[2], T[3], GAMMA)
        assert u.dtype == y.dtype == z.dtype == T[0].dtype
        assert _err(u, np.asarray(u_ref)[:m]) < tol
        assert _err(u, np.asarray(u_or)[:m]) < tol
        assert _err(y, np.asarray(y_ref)[:m]) < tol
        assert _err(z, np.asarray(z_ref)[:m]) < tol
        assert _err(z, np.asarray(z_or)[:m]) < tol
    assert ops.launch_counts() == before     # CPU tensors never launch


def test_plain_versions_are_the_worker_loop():
    """The batched plain versions equal a loop over workers and rows of
    the single-RHS reference oracles (the worker axis is exact)."""
    A, B, X, Xb = _inputs(6, 40, 4, np.float64, seed=2)
    T = [torch.as_tensor(a) for a in (A, B, X, Xb)]
    u = ops.apc_gather_ref(T[0], T[2], T[3]).numpy()
    y = ops.block_projection_ref(T[0], T[1], T[2], T[3], 1.1).numpy()
    for w in range(M):
        for i in range(4):
            np.testing.assert_allclose(
                u[w, i], np.asarray(ref_ref.apc_gather_ref(A[w], X[w, i],
                                                           Xb[i])),
                rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(
                y[w, i], np.asarray(ref_ref.block_projection_ref(
                    A[w], B[w], X[w, i], Xb[i], 1.1)),
                rtol=1e-13, atol=1e-13)


def test_transposed_batch_view_is_accepted():
    """solve_many hands the ops the (m, k, n) transpose of its (k, m, n)
    iterate; the result equals that of a contiguous copy."""
    A, B, X, Xb = _inputs(5, 33, 3, np.float64, seed=4)
    T = [torch.as_tensor(a) for a in (A, B, X, Xb)]
    Xt = T[2].transpose(0, 1).contiguous().transpose(0, 1)
    assert not Xt.is_contiguous()
    z = ops.block_projection(T[0], T[1], Xt, T[3], 0.5)
    assert torch.equal(z, ops.block_projection(T[0], T[1], T[2], T[3], 0.5))


def test_no_fallback_between_kernel_and_plain_version():
    """The raw launchers take CUDA tensors only, and the ops accept only
    all-CPU or all-CUDA operands of one float32/float64 dtype."""
    A, B, X, Xb = (torch.as_tensor(a) for a in _inputs(4, 16, 2,
                                                        np.float64))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bp.apc_gather(A, X, Xb)
    with pytest.raises(ValueError, match="CUDA"):
        bp.apc_scatter(B, X, Xb, torch.zeros(M, 2, 4, dtype=A.dtype), 1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.proj_gather(A.to("meta"), X.to("meta"), Xb.to("meta"))
    with pytest.raises(ValueError, match="cpu"):
        ops.proj_gather(A, X.to("meta"), Xb)
    with pytest.raises(TypeError, match="dtypes"):
        ops.proj_gather(A, X.float(), Xb)
    with pytest.raises(TypeError, match="dtypes"):
        ops.block_projection(A.bfloat16(), B.bfloat16(), X.bfloat16(),
                             Xb.bfloat16(), 1.0)
    assert ops.launch_counts() == before


def test_ctypes_signatures_match_the_cuda_source():
    """The CUDA entries cannot be loaded here, so hold the ctypes
    argument types against the extern "C" signatures in the source."""
    import ctypes
    import re
    src = (bp.CSRC / "block_projection.cu").read_text()
    body = src[src.index('extern "C" {'):]
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int64_t": ctypes.c_int64, "double": ctypes.c_double}
    found = 0
    for name, params in re.findall(r"int (\w+)\(([^)]*)\)", body):
        kernel, dt = name.rsplit("_", 1)
        assert dt in ("f64", "f32") and kernel in bp.ARGTYPES, name
        types = [kinds[re.sub(r"\s+\w+$", "", p.strip())]
                 for p in params.split(",")]
        assert types == bp.ARGTYPES[kernel], name
        found += 1
    assert found == 2 * len(bp.KERNELS)
