"""The all-bf16 form of the APC kernel pair against the JAX reference.

The twin of tests/test_kernels.py::test_block_projection_matches_ref at
``dtype=bfloat16``, over its seven (p, n) shapes: the reference's
``ops.block_projection`` (its Pallas kernels in interpret mode) and the
port's (its plain versions on the CPU) on the same bf16 bits, at the
reference's bf16 tolerance, 8e-2 relative to max|ref| + 1.  Beside it,
the two rounding points the form keeps (U in bf16 between the passes, γ
as its bf16 value), a batch, and the dtype pairs the other ops refuse.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

TOL = 8e-2          # tests/test_kernels.py TOL[jnp.bfloat16]
SHAPES = [(8, 128), (16, 512), (7, 130), (32, 1024), (24, 896), (1, 128),
          (64, 4096)]
GAMMA = 1.37


def _mk(p, n, seed=0, k=None):
    """tests/test_kernels.py's ``_mk`` at bfloat16 (x and x̄ with a
    leading k batch when given)."""
    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.standard_normal((p, n)), jnp.bfloat16)
    G = (A @ A.T).astype(jnp.float64)
    B = jnp.asarray(np.linalg.solve(np.asarray(G), np.asarray(
        A, np.float64)), jnp.bfloat16).T
    shape = (n,) if k is None else (k, n)
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    xb = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return A, B, x, xb


def _t(a):
    """A bf16 JAX array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _err(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1.0)


@pytest.mark.parametrize("p,n", SHAPES)
def test_block_projection_matches_ref_bf16(p, n):
    A, B, x, xb = _mk(p, n)
    want = ref_ops.block_projection(A, B, x, xb, GAMMA)
    y = ops.block_projection(_t(A)[None], _t(B).contiguous()[None],
                             _t(x)[None], _t(xb), GAMMA)
    assert y.dtype == torch.bfloat16 and y.shape == (1, n)
    assert _err(y[0], want) < TOL, (p, n)
    assert _err(y[0], ref.block_projection_ref(A, B, x, xb, GAMMA)) < TOL


@pytest.mark.parametrize("p,n", [(8, 128), (24, 896)])
def test_batched_bf16_matches_ref(p, n):
    """A k = 3 batch: each row through one worker, as the reference's
    (k, n) rows share one read of each tile."""
    A, B, x, xb = _mk(p, n, seed=1, k=3)
    want = ref_ops.block_projection(A, B, x, xb, GAMMA)
    X = _t(x)[None]                                   # (1, k, n)
    y = ops.block_projection(_t(A)[None], _t(B).contiguous()[None], X,
                             _t(xb), GAMMA)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 3, n)
    assert _err(y[0], want) < TOL
    # each batch row is the k = 1 call on that row
    for i in range(3):
        row = ops.block_projection(_t(A)[None], _t(B).contiguous()[None],
                                   X[:, i], _t(xb)[i], GAMMA)
        assert torch.equal(row[0], y[0, i])


def test_the_two_rounding_points():
    """U is bf16 between the two passes, accumulated in float32; γ is
    applied as its bf16 value, in float32; Y is bf16."""
    A, B, x, xb = (t[None] if t.dim() == 2 else t for t in map(
        _t, _mk(16, 512)))
    X = x[None]
    U = ops.proj_gather(A, X, xb)
    assert U.dtype == torch.bfloat16
    u32 = torch.einsum("mpn,mn->mp", A.float(), xb.float() - X.float())
    assert float((U.float() - u32).abs().max()) <= float(
        u32.abs().max()) * 2.0 ** -8
    g = float(torch.tensor(GAMMA, dtype=torch.bfloat16))
    assert g != GAMMA and ops._gamma(GAMMA, torch.bfloat16) == g
    assert ops._gamma(GAMMA, torch.float64) == GAMMA
    Y = ops.proj_scatter(B, X, xb, U, GAMMA)
    assert Y.dtype == torch.bfloat16
    assert torch.equal(Y, ops.proj_scatter(B, X, xb, U, g))
    d = xb.float() - X.float()
    y32 = X.float() + g * (d - torch.einsum("mnp,mp->mn", B.float(),
                                            U.float()))
    assert float((Y.float() - y32).abs().max()) <= float(
        y32.abs().max()) * 2.0 ** -8


def test_only_the_apc_pair_takes_all_bf16():
    """The other five kernels keep the four pairs: their ops refuse an
    all-bf16 call before a plain version runs."""
    A = torch.ones((2, 3, 16), dtype=torch.bfloat16)
    B = torch.ones((2, 16, 3), dtype=torch.bfloat16)
    X = torch.ones((2, 16), dtype=torch.bfloat16)
    Xb = torch.ones(16, dtype=torch.bfloat16)
    b = torch.ones((2, 3), dtype=torch.bfloat16)
    cols = torch.arange(32).reshape(2, 16) % 16
    assert bp.pairs("apc_gather") == bp.pairs("apc_scatter") == bp.PAIRS
    for kn in bp.KERNELS:
        assert ((torch.bfloat16, torch.bfloat16) in bp.pairs(kn)) == (
            kn in bp.ALL_BF16)
    ops.block_projection(A, B, X, Xb, 0.5)
    for call in (lambda: ops.cimmino_update(A, B, b, Xb),
                 lambda: ops.cimmino_gather(A, Xb),
                 lambda: ops.sparse_proj_update(A, cols, B, X, Xb, 0.5),
                 lambda: ops.sparse_cimmino_update(A, cols, B, b, Xb)):
        with pytest.raises(TypeError, match="dtypes"):
            call()
    assert bp.launch_counts("bf16_bf16") == dict.fromkeys(bp.KERNELS, 0)
