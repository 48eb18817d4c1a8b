"""Sparse block systems in the port against the JAX reference.

The same seeded systems go through both packages: the sparse generators
and ``as_sparse`` (bit-identical), the sparse ``blockops`` (1e-12), the
sparse kernel ops (the port's plain versions against the reference's
Pallas ops in interpret mode, tests/test_kernels.py tolerances), every
sparse-capable solver against the reference and against its own
densified twin (tests/test_modes.py tolerances), the capability matrix
and the store condition the port's sparse kernels rely on.  The
reference's engine is pinned to its fused kernels
(``REPRO_KERNEL_ENGINE=fused``) wherever its kernel path is compared, as
the port launches its kernels at every batch size.  The CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.
"""
import contextlib
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.core import blockops as ref_blockops  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.launch import solve as ref_cli  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core import blockops, partition  # noqa: E402
from repro_torch.core.apc import APCState  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import solve as cli  # noqa: E402
from repro_torch.solvers.projection import ProjFactors  # noqa: E402

torch.set_num_threads(1)

# tests/test_kernels.py; bf16 relative to max|ref| + 1, as its TOL
TOL = {np.float32: 2e-5, np.float64: 1e-12, jnp.bfloat16: 8e-2}
# tests/test_modes.py::test_sparse_matches_densified
X_TOL = dict(rtol=1e-8, atol=1e-10)
HIST_TOL = dict(rtol=1e-6, atol=1e-12)
SPARSE_OK = ["apc", "consensus", "cimmino", "dgd", "dnag", "dhbm", "madmm"]
KERNEL = ["apc", "consensus", "cimmino"]
# tests/test_kernel_corners.py: odd support width and n not a multiple of
# 128; p = 1 workers; the plain even case
CORNERS = {"odd-w-n130": dict(n=130, m=2, bandwidth=6),
           "p1": dict(n=24, m=24, bandwidth=2),
           "even": dict(n=192, m=4, bandwidth=6)}
KERNEL_ITERS = 60          # the reference's kernel path runs interpreted
GAMMA = 0.83


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv(ref_ops.ENGINE_ENV, "fused")


@pytest.fixture(scope="module")
def corner():
    memo = {}

    def get(key):
        if key not in memo:
            memo[key] = (ref_linsys.banded_system(seed=0, **CORNERS[key]),
                         linsys.banded_system(seed=0, device="cpu",
                                              **CORNERS[key]))
        return memo[key]
    return get


@pytest.fixture(scope="module")
def sparse_sys(corner):
    """(reference, port) banded n=192, m=4 (tests/test_modes.py)."""
    return corner("even")


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.double() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _torch(a):
    """A numpy array as a torch tensor, a bf16 one bit for bit."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.as_tensor(a)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _err(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1.0)


# ---------------------------------------------------------------------------
# generators, as_sparse and the system contract
# ---------------------------------------------------------------------------


def _same_sparse(ref_sys, port_sys):
    for field in ("A_blocks", "b_blocks", "x_true"):
        assert np.array_equal(np.asarray(getattr(ref_sys, field)),
                              getattr(port_sys, field).numpy()), field
    assert port_sys.is_sparse and ref_sys.mode == port_sys.mode
    assert port_sys.cols.dtype == torch.int64
    assert np.array_equal(np.asarray(ref_sys.cols), port_sys.cols.numpy())
    assert port_sys.sparsity == ref_sys.sparsity


@pytest.mark.parametrize("name,kw", [
    *(("banded_system", dict(seed=0, **spec)) for spec in CORNERS.values()),
    ("banded_system", dict(n=128, m=4, bandwidth=8, seed=3)),
    ("block_sparse_system", dict(n=96, m=4, density=0.2, seed=0)),
    ("sparse_matrix_market_proxy", dict(key="orsirr1", seed=1)),
], ids=["banded-odd-w", "banded-p1", "banded-even", "banded-n128",
        "block_sparse", "orsirr1_sparse"])
def test_sparse_generators_bit_identical(name, kw):
    _same_sparse(getattr(ref_linsys, name)(**kw),
                 getattr(linsys, name)(**kw, device="cpu"))


def test_as_sparse_cols_match_reference():
    """A dense system with a ragged zero pattern: the same sorted
    supports, padded with each block's first all-zero column."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((24, 40))
    A[rng.random(A.shape) < 0.7] = 0.0
    A[:6, :] = 0.0
    A[:6, 3] = 1.0                       # a block with one column
    b = rng.standard_normal(24)
    ref = ref_partition.as_sparse(ref_partition.partition(A, b, 4))
    port = partition.as_sparse(partition.partition(A, b, 4, device="cpu"))
    assert np.array_equal(np.asarray(ref.cols), port.cols.numpy())
    assert port.mode == ref.mode == "least_squares"
    twin = port.densified()
    assert not twin.is_sparse and twin.cols is None
    assert torch.equal(partition.as_sparse(twin).cols, port.cols)


def test_sparse_system_contract():
    """Checked once, at construction: cols in range, and a repeated index
    only on an all-zero column of its block (the sparse kernels store
    where the reference adds; the reference accepts either system)."""
    A = torch.zeros(2, 2, 6, dtype=torch.float64)
    A[0, :, 1:3] = 1.0
    A[1, :, 3:5] = 2.0
    b = torch.ones(2, 2, dtype=torch.float64)
    ok = partition.BlockSystem(A, b, structure="sparse",
                               cols=np.array([[1, 2, 0, 0], [3, 4, 5, 5]],
                                             np.int32))
    assert ok.cols.dtype == torch.int64                   # converted once
    assert torch.equal(blockops.densify(ok.A_op), A)
    assert ok.A_op is ok.A_op                             # gathered once
    with pytest.raises(ValueError, match="outside"):
        partition.BlockSystem(A, b, structure="sparse",
                              cols=torch.tensor([[1, 2], [3, 6]]))
    with pytest.raises(ValueError, match="outside"):
        partition.BlockSystem(A, b, structure="sparse",
                              cols=torch.tensor([[1, -1], [3, 4]]))
    with pytest.raises(ValueError, match="nonzero in its block"):
        partition.BlockSystem(A, b, structure="sparse",
                              cols=torch.tensor([[1, 2, 2], [3, 4, 0]]))
    with pytest.raises(ValueError, match="shape"):
        partition.BlockSystem(A, b, structure="sparse",
                              cols=torch.tensor([1, 2]))


# ---------------------------------------------------------------------------
# blockops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
def test_blockops_match_reference(sparse_sys, batched):
    ref_sys, sys_ = sparse_sys
    Ar, Ap = ref_sys.A_op, sys_.A_op
    m, p, n = sys_.m, sys_.p, sys_.n
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, n) if batched else (n,))
    D = rng.standard_normal((3, m, n) if batched else (m, n))
    u = rng.standard_normal((3, m, p) if batched else (m, p))
    T = [torch.as_tensor(a) for a in (x, D, u)]
    if batched:
        pairs = [
            (blockops.bmatvec_many(Ap, T[0]),
             ref_blockops.bmatvec_many(Ar, x)),
            (blockops.brmatvec_sum_many(Ap, T[2]),
             ref_blockops.brmatvec_sum_many(Ar, u)),
            (blockops.bmatvec_each(Ap, T[1]),
             jax.vmap(ref_blockops.bmatvec_each, (None, 0))(Ar, D)),
            (blockops.brmatvec(Ap, T[2]),
             jax.vmap(ref_blockops.brmatvec, (None, 0))(Ar, u)),
        ]
    else:
        pairs = [
            (blockops.bmatvec(Ap, T[0]), ref_blockops.bmatvec(Ar, x)),
            (blockops.bmatvec_each(Ap, T[1]),
             ref_blockops.bmatvec_each(Ar, D)),
            (blockops.brmatvec(Ap, T[2]), ref_blockops.brmatvec(Ar, u)),
            (blockops.brmatvec_sum(Ap, T[2]),
             ref_blockops.brmatvec_sum(Ar, u)),
            (blockops.bgram(Ap), ref_blockops.bgram(Ar)),
            (blockops.densify(Ap), ref_blockops.densify(Ar)),
        ]
    for got, want in pairs:
        assert _err(got, want) < 1e-12
    # the dense twin: same values through the dense branches
    assert _err(blockops.bmatvec(sys_.A_blocks, T[0]),
                blockops.bmatvec(Ap, T[0])) < 1e-12
    assert blockops.ncols(Ap) == ref_blockops.ncols(Ar) == n
    assert blockops.block_shape(Ap) == ref_blockops.block_shape(Ar)
    assert blockops.block_dtype(Ap) == torch.float64
    assert blockops.is_sparse(Ap) and not blockops.is_sparse(sys_.A_blocks)


# ---------------------------------------------------------------------------
# the sparse kernel ops (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _op_inputs(sys_, k, dtype, seed=5):
    """Compressed vals/cols/Bvals of a system's own kernel factors, and
    seeded X, X̄, b (worker-first, k = 1 without the k axis)."""
    s = solvers.get("apc")
    f = s.kernel_factors(s.prepare(sys_.A_op, {}))
    rng = np.random.default_rng(seed)
    m, p, n = sys_.m, sys_.p, sys_.n
    shape = (lambda *a: a) if k > 1 else (lambda *a: a[:-2] + a[-1:])
    X = rng.standard_normal(shape(m, k, n))
    Xb = rng.standard_normal((k, n) if k > 1 else (n,))
    b = rng.standard_normal(shape(m, k, p))
    arrs = [f.A.vals.numpy(), f.A.cols.numpy(), f.B.numpy(), X, Xb, b]
    return [a if a.dtype == np.int64 else a.astype(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("key", sorted(CORNERS))
def test_sparse_ops_match_reference(corner, key, k, dtype):
    """Both sparse ops against the reference's worker-vmapped Pallas ops
    (interpret mode) and its jnp oracles, at the corner shapes;
    bfloat16 is the all-bf16 form, fed the same bits."""
    vals, cols, Bv, X, Xb, b = _op_inputs(corner(key)[1], k, dtype)
    J = [jnp.asarray(a) for a in (vals, cols.astype(np.int32), Bv, X, Xb,
                                  b)]
    y_ref, u_ref = jax.vmap(ref_ops.sparse_proj_update,
                            (0, 0, 0, 0, None, None))(*J[:5], GAMMA)
    y_or, u_or = jax.vmap(ref_ref.sparse_proj_update_ref,
                          (0, 0, 0, 0, None, None))(*J[:5], GAMMA)
    r_ref, c_ref = jax.vmap(ref_ops.sparse_cimmino_update,
                            (0, 0, 0, 0, None))(*J[:3], J[5], J[4])
    T = [_torch(a) for a in (vals, cols, Bv, X, Xb, b)]
    before = ops.launch_counts()
    y, u = ops.sparse_proj_update(*T[:5], GAMMA)
    r, c = ops.sparse_cimmino_update(*T[:3], T[5], T[4])
    assert ops.launch_counts() == before     # CPU tensors never launch
    assert y.dtype == u.dtype == r.dtype == T[0].dtype
    tol = TOL[dtype]
    for got, want in ((y, y_ref), (u, u_ref), (y, y_or), (u, u_or),
                      (r, r_ref), (c, c_ref)):
        assert _err(got, want) < tol


def test_sparse_ops_are_the_worker_loop(corner):
    """The batched plain versions equal a loop over workers and rows of
    the reference's single-RHS oracles, and a transposed (m, k, n) view
    of the iterate gives the result of a contiguous copy."""
    vals, cols, Bv, X, Xb, b = _op_inputs(corner("even")[1], 3, np.float64)
    T = [torch.as_tensor(a) for a in (vals, cols, Bv, X, Xb, b)]
    y, u = ops.sparse_proj_update(*T[:5], 1.1)
    r, _ = ops.sparse_cimmino_update(*T[:3], T[5], T[4])
    vals, cols, Bv, X, Xb, b = (jnp.asarray(a) for a in (vals, cols, Bv, X,
                                                       Xb, b))
    for w in range(vals.shape[0]):
        for i in range(3):
            yw, uw = ref_ref.sparse_proj_update_ref(
                vals[w], cols[w], Bv[w], X[w, i], Xb[i], 1.1)
            rw, _ = ref_ref.sparse_cimmino_update_ref(
                vals[w], cols[w], Bv[w], b[w, i], Xb[i])
            _close(y[w, i], yw, rtol=1e-13, atol=1e-13)
            _close(u[w, i], uw, rtol=1e-13, atol=1e-13)
            _close(r[w, i], rw, rtol=1e-13, atol=1e-13)
    Xt = T[3].transpose(0, 1).contiguous().transpose(0, 1)
    assert not Xt.is_contiguous()
    yt, ut = ops.sparse_proj_update(T[0], T[1], T[2], Xt, T[4], 1.1)
    assert torch.equal(yt, y) and torch.equal(ut, u)


def test_sparse_launchers_take_cuda_tensors_only(corner):
    vals, cols, Bv, X, Xb, b = (torch.as_tensor(a) for a in _op_inputs(
        corner("even")[1], 2, np.float64))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bp.sparse_gather(vals, cols, X, Xb)
    with pytest.raises(ValueError, match="CUDA"):
        bp.sparse_cimmino_gather(vals, cols, Xb)
    with pytest.raises(ValueError, match="CUDA"):
        bp.sparse_scatter(Bv, cols, b, torch.zeros_like(X))
    with pytest.raises(TypeError, match="int64"):
        bp.sparse_gather(vals, cols.int(), X, Xb)
    with pytest.raises(TypeError, match="int64"):
        ops.sparse_proj_update(vals, cols.int(), Bv, X, Xb, 1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.sparse_cimmino_update(vals.to("meta"), cols, Bv.to("meta"),
                                  b.to("meta"), Xb.to("meta"))
    with pytest.raises(TypeError, match="dtypes"):
        ops.sparse_cimmino_update(vals, cols, Bv, b.float(), Xb)
    assert ops.launch_counts() == before


def _bits(a):
    """An array's bits, as unsigned integers of its width."""
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("key", sorted(CORNERS))
def test_support_ref_is_the_reference_support_gather(corner, key, k, dtype):
    """``ops.support_ref``, the plain version of the sparse gathers'
    pre-pass, against the reference's support gathers on the same
    seeded bits (``xs = x2[:, cols]``, ``xbs = xb2[:, cols]`` of
    src/repro/kernels/ops.py sparse_proj_update, ``xbs`` of
    sparse_cimmino_update), worker by worker, bit for bit: X̄ₛ alone, and
    X̄ₛ − Xₛ taken in the accumulation dtype (float32 for bf16, as the
    reference's kernel widens both before it subtracts).  The corners
    hold an odd support width (71) and, where a worker's band is short,
    the repeated all-zero padding column of as_sparse."""
    vals, cols, Bv, X, Xb, b = _op_inputs(corner(key)[1], k, dtype)
    if key == "p1":                 # as_sparse's padding repeats an index
        assert any(len(set(c)) < len(c) for c in cols.tolist())
    acc = np.float32 if dtype == jnp.bfloat16 else dtype
    x2 = X[:, None] if k == 1 else X                  # (m, k, n)
    xb2 = jnp.asarray(Xb[None] if k == 1 else Xb)     # (k, n)
    xs = np.stack([np.asarray(jnp.asarray(x)[:, jnp.asarray(c, jnp.int32)])
                   for x, c in zip(x2, cols)])
    xbs = np.stack([np.asarray(xb2[:, jnp.asarray(c, jnp.int32)])
                    for c in cols])
    want = {"cimmino": xbs.astype(acc),
            "apc": np.asarray(jnp.asarray(xbs).astype(acc)
                              - jnp.asarray(xs).astype(acc))}
    got = {"cimmino": ops.support_ref(torch.as_tensor(cols), _torch(Xb)),
           "apc": ops.support_ref(torch.as_tensor(cols), _torch(Xb),
                                  _torch(X))}
    for form, g in got.items():
        assert g.dtype == ops._acc(_torch(Xb).dtype), form
        g = g.numpy() if k > 1 else g.numpy()[:, None]
        assert g.shape == want[form].shape, form
        assert np.array_equal(_bits(g), _bits(want[form])), form


@pytest.mark.parametrize("dtype", [np.float32, np.float64, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("key", sorted(CORNERS))
def test_sparse_gather_refs_over_support_ref_keep_their_bits(corner, key, k,
                                                             dtype):
    """``sparse_gather_ref`` and ``sparse_cimmino_gather_ref``, composed
    from ``support_ref``, give the bits of their earlier form, which took
    X̄ − X over every column and then gathered the support."""
    vals, cols, Bv, X, Xb, b = (_torch(a) for a in _op_inputs(
        corner(key)[1], k, dtype))
    acc = ops._acc(X.dtype)
    m = cols.shape[0]
    u = torch.einsum("mpw,m...w->m...p", vals.to(acc), ops._support(
        cols, Xb.to(acc) - X.to(acc))[0]).to(X.dtype)
    uc = torch.einsum("mpw,m...w->m...p", vals.to(acc), ops._support(
        cols, Xb.to(acc).expand((m,) + Xb.shape))[0]).to(Xb.dtype)
    assert torch.equal(ops.sparse_gather_ref(vals, cols, X, Xb), u)
    assert torch.equal(ops.sparse_cimmino_gather_ref(vals, cols, Xb), uc)


# the corner systems' support widths and the instance of sparse_gather
# each takes: vals rows of 71 (odd) or 5 f64 are not 16-byte multiples
@pytest.mark.parametrize("key,dtype,want", [
    ("odd-w-n130", np.float64, "row_dot"),
    ("p1", np.float64, "row_dot"),
    ("even", np.float64, "ring"),
    ("even", np.float32, "ring"),
    ("even", jnp.bfloat16, "row_dot"),   # 120-byte bf16 rows
])
def test_sparse_gather_instance_at_the_corners(corner, key, dtype, want):
    vals, cols, Bv, X, Xb, b = (_torch(a) for a in _op_inputs(
        corner(key)[1], 3, dtype))
    assert vals.shape[-1] == {"odd-w-n130": 71, "p1": 5, "even": 60}[key]
    assert bp.gather_instance(vals) == want


def test_sparse_gather_instance_on_the_sparse_path():
    """The sparse path's banded system (m = 16, p = 2048) has support
    width 2064: 16512-byte f64 rows take the ring, whatever its p; f32 rows
    of 8256 bytes and bf16 rows of 4128 (the mixed and all-bf16 forms)
    too; an odd width does not, nor a view at an odd offset.  The support
    operand the ring copies is the launcher's own buffer
    (``bp.support_buffer``), aligned whatever the width."""
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        assert bp.gather_instance(torch.empty((2, 3, 2064),
                                              dtype=dtype)) == "ring"
        assert bp.gather_instance(torch.empty((2, 3, 2063),
                                              dtype=dtype)) == "row_dot"
    flat = torch.empty(2 * 3 * 2064 + 1, dtype=torch.float64)
    assert bp.gather_instance(flat[1:].view(2, 3, 2064)) == "row_dot"
    with pytest.raises(ValueError, match="row dot"):
        bp.gather_instance(flat[1:].view(2, 3, 2064), forced="ring")


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("pair", list(bp.PAIRS), ids=list(bp.PAIRS.values()))
def test_sparse_scatter_instance_on_the_sparse_path(pair, k):
    """At the sparse path's p = 2048, ``sparse_scatter`` takes its ring in
    every pair at k = 1 and k = 8, the staged U or V the (m, k, p) view
    of a (k, m, p) batch: the FP64 tensor cores in float64 and
    bf16/float64 (``MMA_FORMS``), the bf16 ones in all-bf16
    (``BF16_MMA_FORMS``), the FFMA ring in float32 and bf16/float32 — no
    fixed k = 1 rule, as the dense float64 and float32 scatters keep.  An
    odd p, or U at an odd offset, takes the row dot."""
    mdt, dt = pair
    Bv = torch.empty((2, 3, 2048), dtype=mdt)           # (m, w, p)
    U = torch.empty((k, 2, 2048), dtype=dt).transpose(0, 1)
    assert bp.gather_instance(Bv, U, scatter="sparse_scatter") == "ring"
    assert bp.gather_instance(Bv[..., :2047], U[..., :2047],
                              scatter="sparse_scatter") == "row_dot"
    flat = torch.empty(k * 2 * 2048 + 1, dtype=dt)
    U_off = flat[1:].view(k, 2, 2048).transpose(0, 1)
    assert bp.gather_instance(Bv, U_off,
                              scatter="sparse_scatter") == "row_dot"
    tc = {"f64": bp.MMA_FORMS, "bf16_f64": bp.MMA_FORMS,
          "bf16_bf16": bp.BF16_MMA_FORMS}.get(bp.PAIRS[pair], ())
    assert ("sparse_scatter", bp.PAIRS[pair]) in tc or dt == torch.float32
    # the dense float64 scatter without a tensor-core form keeps the row
    # dot at k = 1
    if pair == (torch.float64, torch.float64):
        assert bp.gather_instance(Bv, U, scatter="apc_scatter") == (
            "row_dot" if k == 1 else "ring")


@pytest.mark.parametrize("instance", [None, "ring", "row_dot"])
def test_sparse_gather_instance_argument_never_reaches_the_cpu(corner,
                                                               instance):
    vals, cols, Bv, X, Xb, b = (torch.as_tensor(a) for a in _op_inputs(
        corner("even")[1], 2, np.float64))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bp.sparse_gather(vals, cols, X, Xb, _instance=instance)
    with pytest.raises(TypeError):
        bp.sparse_gather(vals, cols, X, Xb, instance)
    assert ops.launch_counts() == before


def test_compressed_factors_keep_the_fused_residual_exact(sparse_sys):
    """APC's sparse u is the residual block only because A_i B_i = I on
    the compressed factors; padded support slots carry zero Bvals rows."""
    sys_ = sparse_sys[1]
    s = solvers.get("apc")
    f = s.kernel_factors(s.prepare(sys_.A_op, {}))
    eye = torch.eye(sys_.p, dtype=torch.float64).expand(sys_.m, -1, -1)
    assert _err(f.A.vals @ f.B, eye) < 1e-12
    for w in range(sys_.m):
        c = f.A.cols[w]
        first = {int(j): i for i, j in reversed(list(enumerate(c)))}
        dups = [i for i, j in enumerate(c.tolist()) if first[j] != i]
        assert torch.all(f.B[w, dups] == 0) and torch.all(
            f.A.vals[w][:, dups] == 0)
    prm = s.resolve_params(sys_)
    state = s.init(f, sys_.b_blocks, prm)
    for _ in range(3):
        state = s.step(f, sys_.b_blocks, state, prm)
    _, rsq = s.step_residual(f, sys_.b_blocks, state, prm)
    r = blockops.bmatvec(sys_.A_op, state.xbar) - sys_.b_blocks
    assert float(rsq) == pytest.approx(float(torch.sum(r * r)), rel=1e-10)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unfused_solves(sparse_sys):
    """name -> (port sparse, port densified, reference sparse), 150 iters
    on the unfused path, each solved once for the module."""
    memo = {}

    def get(name):
        if name not in memo:
            ref_sys, sys_ = sparse_sys
            prm = ref_solvers.get(name).resolve_params(ref_sys)
            prm = {k: float(v) for k, v in prm.items()}
            s = solvers.get(name)
            memo[name] = (s.solve(sys_, iters=150, **prm),
                          s.solve(sys_.densified(), iters=150, **prm),
                          ref_solvers.get(name).solve(ref_sys, iters=150,
                                                      **prm))
        return memo[name]
    return get


@pytest.mark.parametrize("name", SPARSE_OK)
def test_sparse_solve_matches_reference(unfused_solves, name):
    r, _, r_ref = unfused_solves(name)
    _close(r.x, r_ref.x, **X_TOL)
    _close(r.residuals, r_ref.residuals, **HIST_TOL)
    _close(r.errors, r_ref.errors, **HIST_TOL)
    assert r.iters_to_tol == r_ref.iters_to_tol


@pytest.mark.parametrize("name", SPARSE_OK)
def test_sparse_matches_densified(unfused_solves, name):
    r, r_dn, _ = unfused_solves(name)
    _close(r.x, r_dn.x, **X_TOL)
    _close(r.residuals, r_dn.residuals, **HIST_TOL)


@pytest.mark.parametrize("name", KERNEL)
def test_sparse_kernel_path_matches_unfused_and_densified(sparse_sys,
                                                          name):
    """The kernel path (plain versions here) against the unfused sparse
    path (tests/test_kernel_engine.py: rtol 1e-6) and against the
    densified twin's dense kernel path, with no RuntimeWarning."""
    sys_ = sparse_sys[1]
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    plan = solvers.ExecutionPlan(kernel=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        rk = s.solve(sys_, iters=150, plan=plan, **prm)
    ru = s.solve(sys_, iters=150, **prm)
    rd = s.solve(sys_.densified(), iters=150, plan=plan, **prm)
    _close(rk.residuals, ru.residuals, rtol=1e-6, atol=1e-12)
    _close(rk.x, ru.x, rtol=1e-6, atol=1e-12)
    _close(rk.x, rd.x, **X_TOL)
    _close(rk.residuals, rd.residuals, **HIST_TOL)


@pytest.mark.parametrize("key", sorted(CORNERS))
@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_sparse_kernel_matches_reference_at_corner_shapes(corner, fused,
                                                          name, key):
    """tests/test_kernel_corners.py::test_sparse_kernel_exact_at_corner_shapes
    held across the packages: both kernel paths on the same system."""
    ref_sys, sys_ = corner(key)
    prm = {k: float(v) for k, v in
           ref_solvers.get(name).resolve_params(ref_sys).items()}
    r_ref = ref_solvers.get(name).solve(
        ref_sys, iters=KERNEL_ITERS,
        plan=ref_solvers.ExecutionPlan(kernel=True), **prm)
    r = solvers.get(name).solve(sys_, iters=KERNEL_ITERS,
                                plan=solvers.ExecutionPlan(kernel=True),
                                **prm)
    _close(r.x, r_ref.x, **X_TOL)
    _close(r.residuals, r_ref.residuals, **HIST_TOL)


def test_consensus_sparse_kernel_matches_reference(sparse_sys, fused):
    ref_sys, sys_ = sparse_sys
    r_ref = ref_solvers.get("consensus").solve(
        ref_sys, iters=KERNEL_ITERS,
        plan=ref_solvers.ExecutionPlan(kernel=True))
    r = solvers.get("consensus").solve(
        sys_, iters=KERNEL_ITERS, plan=solvers.ExecutionPlan(kernel=True))
    _close(r.x, r_ref.x, **X_TOL)
    _close(r.residuals, r_ref.residuals, **HIST_TOL)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_sparse_solve_many(sparse_sys, fused, name, kernel):
    """solve_many on a sparse system: against the reference's, against
    the densified twin's, and row by row against single solves."""
    ref_sys, sys_ = sparse_sys
    s = solvers.get(name)
    prm = s.resolve_params(sys_)
    iters = KERNEL_ITERS if kernel else 150
    Bm = np.random.default_rng(3).standard_normal((3, sys_.N))
    plan = solvers.ExecutionPlan(kernel=kernel)
    r = s.solve_many(sys_, Bm, iters=iters, plan=plan, **prm)
    r_ref = ref_solvers.get(name).solve_many(
        ref_sys, Bm, iters=iters,
        plan=ref_solvers.ExecutionPlan(kernel=kernel), **prm)
    r_dn = s.solve_many(sys_.densified(), Bm, iters=iters, plan=plan, **prm)
    assert r.x.shape == (3, sys_.n) and r.residuals.shape == (3, iters)
    for other in (r_ref, r_dn):
        _close(r.x, other.x, **X_TOL)
        _close(r.residuals, other.residuals, **HIST_TOL)
    for i in range(3):
        row = partition.BlockSystem(sys_.A_blocks, torch.as_tensor(
            Bm[i]).reshape(sys_.m, sys_.p), structure="sparse",
            cols=sys_.cols, mode="square")
        one = s.solve(row, iters=iters, plan=plan, **prm)
        _close(r.x[i], one.x, rtol=1e-12, atol=1e-12)
        _close(r.residuals[i], one.residuals, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# capability matrix
# ---------------------------------------------------------------------------


def test_capability_matrix_is_the_reference(sparse_sys):
    assert solvers.available() == ref_solvers.available()
    for name in solvers.available():
        assert (solvers.get(name).supports
                == ref_solvers.get(name).supports), name
    with pytest.raises(solvers.CapabilityError, match="sparse") as ei:
        solvers.get("pdhbm").solve(sparse_sys[1], iters=5)
    msg = str(ei.value)
    assert "'pdhbm'" in msg and "supports=['square']" in msg
    assert "structure='sparse'" in msg and "A9" not in msg


def test_sparse_kernel_without_engine_falls_back_loudly(sparse_sys):
    """dgd has no kernel: on a sparse system kernel=True warns and runs
    the unfused path, bit for bit; on a dense system it stays an
    error."""
    sys_ = sparse_sys[1]
    s = solvers.get("dgd")
    prm = s.resolve_params(sys_)
    with pytest.warns(RuntimeWarning, match="supports_kernel=False"):
        r_k = s.solve(sys_, iters=100,
                      plan=solvers.ExecutionPlan(kernel=True), **prm)
    r = s.solve(sys_, iters=100, **prm)
    assert torch.equal(r_k.x, r.x)
    assert torch.equal(r_k.residuals, r.residuals)
    with pytest.raises(ValueError, match="no kernel path"):
        s.solve(sys_.densified(), iters=1,
                plan=solvers.ExecutionPlan(kernel=True), **prm)


# ---------------------------------------------------------------------------
# interop and the CLI
# ---------------------------------------------------------------------------


def test_reference_sparse_factors_and_state_continue_in_port(sparse_sys,
                                                             fused):
    """A reference sparse system, its compressed kernel factors and an
    iteration state carry across; the port continues the iteration."""
    ref_sys, sys_ = sparse_sys
    r = ref_solvers.get("apc")
    prm = r.resolve_params(ref_sys)
    f_ref = r.kernel_factors(r.prepare(ref_sys.A_op, prm))
    st = r.init(f_ref, ref_sys.b_blocks, prm)
    for _ in range(5):
        st = r.step(f_ref, ref_sys.b_blocks, st, prm, use_kernel=True)
    port_sys = interop.system_from_numpy(
        ref_sys.A_blocks, ref_sys.b_blocks, ref_sys.x_true, mode=ref_sys.mode,
        cols=ref_sys.cols, device="cpu")
    assert port_sys.is_sparse and torch.equal(port_sys.cols, sys_.cols)
    f = interop.from_numpy(ProjFactors, *f_ref, device="cpu")
    assert blockops.is_sparse(f.A) and f.A.cols.dtype == torch.int64
    assert f.B.shape == (sys_.m, sys_.cols.shape[1], sys_.p)
    state = interop.from_numpy(APCState, *st, device="cpu")
    s = solvers.get("apc")
    for _ in range(3):
        state = s.step(f, port_sys.b_blocks, state, prm, use_kernel=True)
        st = r.step(f_ref, ref_sys.b_blocks, st, prm, use_kernel=True)
    _close(state.xbar, st.xbar, rtol=0, atol=1e-12)


def test_cli_runs_a_sparse_problem():
    argv = ["--problem", "banded", "--workers", "4", "--iters", "30"]
    outs = []
    for main, extra in ((ref_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].startswith("done in") and "rel-error" in lines[-1]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv + ["--device", "cpu", "--method", "cimmino",
                                "--use-kernel"]) == 0
    # a method without a kernel, --use-kernel on a sparse problem: both
    # CLIs warn and solve unfused, and print the same lines
    kern = ["--method", "dgd", "--iters", "5", "--use-kernel"]
    outs = []
    for main, extra in ((ref_cli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.warns(
                RuntimeWarning, match="unfused sparse path"):
            assert main(argv + kern + extra) == 0
        outs.append(buf.getvalue().splitlines())
    ref_lines, lines = outs
    assert lines[:-1] == ref_lines[:-1]
    assert lines[-1].split(":", 1)[1] == ref_lines[-1].split(":", 1)[1]
    # on a dense problem the same request is the library's ValueError
    with pytest.raises(ValueError, match="no kernel path"):
        cli.main(["--problem", "std_gaussian", "--workers", "4", "--iters",
                  "5", "--method", "dgd", "--use-kernel", "--device", "cpu"])
