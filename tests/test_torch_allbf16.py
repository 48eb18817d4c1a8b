"""The all-bf16 form of the kernel ops against the JAX reference.

The twin of tests/test_kernels.py::test_block_projection_matches_ref at
``dtype=bfloat16``, over its seven (p, n) shapes: the reference's
``ops.block_projection`` (its Pallas kernels in interpret mode) and the
port's (its plain versions on the CPU) on the same bf16 bits, at the
reference's bf16 tolerance, 8e-2 relative to max|ref| + 1.  Beside it,
the rounding points the form keeps (U in bf16 between the passes, γ as
its bf16 value; in Cimmino U before b − U; in the sparse ops C before
it is scaled and added, the pre-pass and the sum at the support
columns), a batch, the float64, float32 and bf16-stored results the
rounding points leave as they were, the dtype pairs every op takes and
refuses, and the one deliberate difference from the reference: its
gathers accumulate U in bf16 across BN tiles, the port's in float32
over the whole row (ROADMAP C).  The Cimmino and sparse ops' bf16
parity is in tests/test_torch_cimmino.py and tests/test_torch_sparse.py.
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


def _op_calls(mdt, dt):
    """Every op of the kernel path on small operands, its matrices in
    ``mdt`` and the others in ``dt``."""
    A = torch.ones((2, 3, 16), dtype=mdt)
    B = torch.ones((2, 16, 3), dtype=mdt)
    X = torch.ones((2, 16), dtype=dt)
    Xb = torch.ones(16, dtype=dt)
    b = torch.ones((2, 3), dtype=dt)
    cols = torch.arange(32).reshape(2, 16) % 16
    return {"block_projection": lambda: ops.block_projection(A, B, X, Xb,
                                                             0.5),
            "cimmino_update": lambda: ops.cimmino_update(A, B, b, Xb),
            "cimmino_gather": lambda: ops.cimmino_gather(A, Xb),
            "cimmino_scatter": lambda: ops.cimmino_scatter(B, b),
            "sparse_proj_update": lambda: ops.sparse_proj_update(
                A, cols, B, X, Xb, 0.5)[0],
            "sparse_cimmino_update": lambda: ops.sparse_cimmino_update(
                A, cols, B, b, Xb)[0]}


def test_only_the_apc_pair_takes_all_bf16():
    """Every op of the kernel path, whose kernels all have the five
    pairs' C entries (the name predates the other five kernels' all-bf16
    entries), takes each pair of ``block_projection.PAIRS`` and returns
    the operands' dtype; every other pair (float32/float64 mixes,
    float16) is refused before a plain version runs.  CPU tensors launch
    nothing."""
    assert set(bp._launches) == {(kn, sfx) for kn in bp.KERNELS
                                 for sfx in bp.PAIRS.values()}
    before = bp.launch_counts()
    for mdt, dt in bp.PAIRS:
        for name, call in _op_calls(mdt, dt).items():
            assert call().dtype == dt, (name, mdt, dt)
    for mdt, dt in ((torch.float32, torch.float64),
                    (torch.float64, torch.float32),
                    (torch.bfloat16, torch.float16),
                    (torch.float16, torch.float16),
                    (torch.float16, torch.float32)):
        assert (mdt, dt) not in bp.PAIRS
        for name, call in _op_calls(mdt, dt).items():
            with pytest.raises(TypeError, match="dtypes"):
                call()
    assert bp.launch_counts() == before


def _bf(t):
    return t.to(torch.bfloat16)


def _sparse_inputs(k=None, seed=3):
    """Seeded bf16 vals (m, p, w), cols (m, w) of distinct columns, Bvals
    (m, w, p), X (m, [k,] n), X̄ ([k,] n), b (m, [k,] p)."""
    rng = np.random.default_rng(seed)
    m, p, w, n = 3, 16, 40, 200
    cols = torch.as_tensor(np.stack([np.sort(rng.permutation(n)[:w])
                                     for _ in range(m)]))
    g = lambda *s: _bf(torch.as_tensor(rng.standard_normal(s)))  # noqa
    kk = () if k is None else (k,)
    return (g(m, p, w), cols, g(m, w, p), g(m, *kk, n), g(*kk, n),
            g(m, *kk, p))


@pytest.mark.parametrize("k", [None, 3])
def test_cimmino_rounding_points(k):
    """All-bf16 Cimmino: U accumulated in float32 and rounded to bf16
    before b − U (a bf16 subtraction), R accumulated in float32 and
    rounded once, as the reference's ``ops.cimmino_update`` rounds; a U
    kept in float32 gives other bits."""
    f = torch.Tensor.float
    rng = np.random.default_rng(4)
    A = _bf(torch.as_tensor(rng.standard_normal((3, 8, 128))))
    B = _bf(torch.as_tensor(rng.standard_normal((3, 128, 8))))
    kk = () if k is None else (k,)
    Xb = _bf(torch.as_tensor(rng.standard_normal((*kk, 128))))
    b = _bf(torch.as_tensor(rng.standard_normal((3, *kk, 8))))
    U = ops.cimmino_gather(A, Xb)
    u32 = torch.einsum("mpn,...n->m...p", f(A), f(Xb))
    assert torch.equal(U, _bf(u32))
    R = ops.cimmino_update(A, B, b, Xb)
    assert R.dtype == torch.bfloat16
    want = _bf(torch.einsum("mnp,m...p->m...n", f(B), f(b - U)))
    assert torch.equal(R, want)
    assert torch.equal(ops.cimmino_scatter(B, b - U), want)
    assert not torch.equal(R, _bf(torch.einsum("mnp,m...p->m...n", f(B),
                                              f(b) - u32)))


@pytest.mark.parametrize("k", [None, 3])
def test_sparse_rounding_points(k):
    """All-bf16 sparse ops, as the reference's ``ops.sparse_proj_update``
    and ``ops.sparse_cimmino_update`` round: U in bf16 (float32
    accumulation) before the scatter and before b − U; C = Bvals·U in
    bf16 before it is scaled and added; γ as its bf16 value; the
    pre-pass X + γ(X̄ − X) rounded, then the sum at the support columns
    rounded.  Leaving out any one of these roundings changes bits."""
    f = torch.Tensor.float
    vals, cols, Bv, X, Xb, b = _sparse_inputs(k)
    idx = cols if X.dim() == 2 else cols[:, None, :].expand(
        X.shape[:-1] + (-1,))
    Y, U = ops.sparse_proj_update(vals, cols, Bv, X, Xb, GAMMA)
    D = torch.take_along_dim(f(Xb) - f(X), idx, dim=-1)
    u32 = torch.einsum("mpw,m...w->m...p", f(vals), D)
    assert torch.equal(U, _bf(u32))
    g = float(torch.tensor(GAMMA, dtype=torch.bfloat16))

    def y_of(u, gamma, round_c=True, round_pre=True):
        c = torch.einsum("mwp,m...p->m...w", f(Bv), f(u))
        c = f(_bf(c)) if round_c else c
        y0 = f(X) + gamma * (f(Xb) - f(X))
        y0 = f(_bf(y0)) if round_pre else y0
        return _bf(y0.scatter_add(-1, idx, -gamma * c))

    assert torch.equal(Y, y_of(U, g))
    for other in (y_of(u32, g), y_of(U, GAMMA), y_of(U, g, round_c=False),
                  y_of(U, g, round_pre=False)):
        assert not torch.equal(Y, other)
    R, Uc = ops.sparse_cimmino_update(vals, cols, Bv, b, Xb)
    Xs = torch.take_along_dim(f(Xb).expand(X.shape), idx, dim=-1)
    assert torch.equal(Uc, _bf(torch.einsum("mpw,m...w->m...p", f(vals),
                                            Xs)))
    C = _bf(torch.einsum("mwp,m...p->m...w", f(Bv), f(b - Uc)))
    assert torch.equal(R, torch.zeros_like(X).scatter(-1, idx, C))


@pytest.mark.parametrize("k", [None, 3])
def test_sparse_support_operand_is_float32(k):
    """The all-bf16 sparse gathers' support operand (their pre-pass,
    ``ops.support_ref``; the kernels' ``bp.support_buffer``) is float32:
    X̄ − X taken in float32 and kept so, X̄ widened exactly.  A bf16
    buffer would round the difference, and U with it."""
    f = torch.Tensor.float
    vals, cols, Bv, X, Xb, b = _sparse_inputs(k)
    idx = cols if X.dim() == 2 else cols[:, None, :].expand(
        X.shape[:-1] + (-1,))
    D = ops.support_ref(cols, Xb, X)
    assert D.dtype == torch.float32
    assert torch.equal(D, torch.take_along_dim(f(Xb) - f(X), idx, dim=-1))
    assert torch.equal(ops.support_ref(cols, Xb), torch.take_along_dim(
        f(Xb).expand(X.shape), idx, dim=-1))
    assert not torch.equal(D, f(_bf(D)))
    assert not torch.equal(ops.sparse_gather_ref(vals, cols, X, Xb), _bf(
        torch.einsum("mpw,m...w->m...p", f(vals), f(_bf(D)))))
    assert bp.support_buffer(3, 2, 40, torch.bfloat16, "cpu").dtype == \
        torch.float32


def _frozen_plain(A, B, vals, cols, Bv, X, Xb, b, gamma):
    """The plain versions as they computed before the all-bf16 form
    (each in the operands' dtype, the matrix widened to it)."""
    dt = X.dtype
    cg = torch.einsum("mpn,...n->m...p", A.to(dt), Xb)
    cs = torch.einsum("mnp,m...p->m...n", B.to(dt), b - cg)
    idx = cols[:, None, :].expand(X.shape[:-1] + (-1,))
    su = torch.einsum("mpw,m...w->m...p", vals.to(dt),
                      torch.take_along_dim(Xb - X, idx, dim=-1))
    C = torch.einsum("mwp,m...p->m...w", Bv.to(dt), su)
    sy = (X + gamma * (Xb - X)).scatter_add(-1, idx, -gamma * C)
    scu = torch.einsum("mpw,m...w->m...p", vals.to(dt), torch.take_along_dim(
        Xb.expand(X.shape), idx, dim=-1))
    Cc = torch.einsum("mwp,m...p->m...w", Bv.to(dt), b - scu)
    sr = torch.zeros_like(X).scatter_add(-1, idx, Cc)
    return cg, cs, su, sy, scu, sr


@pytest.mark.parametrize("pair", [pr for pr in bp.PAIRS
                                  if pr[1] != torch.bfloat16],
                         ids=lambda pr: "/".join(str(d)[6:] for d in pr))
def test_other_forms_are_bit_for_bit_unchanged(pair):
    """For float64, float32 and the bf16-stored pairs ``_acc`` is the
    compute dtype and ``_gamma`` is γ: the plain versions give the bits
    they gave before the all-bf16 form's rounding points."""
    mdt, dt = pair
    assert ops._acc(dt) == dt and ops._gamma(GAMMA, dt) == GAMMA
    rng = np.random.default_rng(7)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    m, p, n, w, k = 3, 8, 128, 40, 3
    cols = torch.as_tensor(np.stack([np.sort(rng.permutation(n)[:w])
                                     for _ in range(m)]))
    A, B = g(m, p, n).to(mdt), g(m, n, p).to(mdt)
    vals, Bv = g(m, p, w).to(mdt), g(m, w, p).to(mdt)
    X, Xb, b = g(m, k, n).to(dt), g(k, n).to(dt), g(m, k, p).to(dt)
    cg, cs, su, sy, scu, sr = _frozen_plain(A, B, vals, cols, Bv, X, Xb, b,
                                            GAMMA)
    assert torch.equal(ops.cimmino_gather(A, Xb), cg)
    assert torch.equal(ops.cimmino_update(A, B, b, Xb), cs)
    y, u = ops.sparse_proj_update(vals, cols, Bv, X, Xb, GAMMA)
    assert torch.equal(u, su) and torch.equal(y, sy)
    r, uc = ops.sparse_cimmino_update(vals, cols, Bv, b, Xb)
    assert torch.equal(uc, scu) and torch.equal(r, sr)


# the reference's gathers add each BN tile's float32 product, rounded to
# bf16, into a bf16 U (its u_ref[...] += ... .astype(u_ref.dtype)); the
# port's sum the whole row in float32 and round once.  At n = 4096 (eight
# 512-column tiles) about half the entries of U differ, by at most some
# 8e-3 of max|U| + 1 (CPU, interpret mode); at one tile none do.
BN_GAP = 1.5e-2


@pytest.mark.parametrize("p,n", [(16, 512), (64, 4096)])
@pytest.mark.parametrize("k", [None, 8])
def test_bf16_gathers_differ_from_the_reference_by_its_bn_tiles(p, n, k):
    """The deliberate difference of the all-bf16 gathers (ROADMAP C),
    sized: ``apc_gather`` (``proj_gather``) and ``cimmino_gather``
    against the reference's ops on the same bits.  One BN tile (n = 512)
    gives the same bits; eight give a gap that is real (entries differ)
    and within BN_GAP, well inside the bf16 tolerance of 8e-2."""
    A, _, x, xb = _mk(p, n, k=k)
    for want, got in (
            (ref_ops.proj_gather(A, x, xb),
             ops.proj_gather(_t(A)[None], _t(x)[None], _t(xb))[0]),
            (ref_ops.cimmino_gather(A, xb),
             ops.cimmino_gather(_t(A)[None], _t(xb))[0])):
        assert got.dtype == _t(want).dtype == torch.bfloat16
        if n == ops.DEFAULT_BN:
            assert torch.equal(got, _t(want))
            continue
        differ = int((got != _t(want)).sum())
        gap = _err(got, want)
        assert 0 < differ and gap < BN_GAP < TOL, (differ, gap)
