"""The port's kernel ops against the JAX reference's Pallas ops.

On the CPU the port's ``proj_gather``/``proj_scatter``/``block_projection``
run their plain PyTorch versions; the reference's ops run their Pallas
kernels in interpret mode, as tests/test_kernels.py runs them.  Same
seeded inputs, the reference's tolerances (tests/test_kernels.py TOL,
relative to max|ref| + 1).  The CUDA kernels themselves are held against
the same plain versions on the card by chip_smoke.py.
"""
import contextlib

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
        ops.cimmino_update(A.bfloat16(), B.bfloat16(),
                           torch.zeros(M, 4, dtype=torch.bfloat16),
                           Xb.bfloat16())
    assert ops.launch_counts() == before


def test_ctypes_signatures_match_the_cuda_source():
    """The CUDA entries cannot be loaded here, so hold the ctypes
    argument types against the extern "C" signatures in the source."""
    import ctypes
    import re
    src = (bp.CSRC / "block_projection.cu").read_text()
    # the entries come from one macro, instantiated once per dtype pair
    body = src[src.index('extern "C" {'):].replace("\\\n", "\n")
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int64_t": ctypes.c_int64, "double": ctypes.c_double}
    def types(params):
        return [kinds[re.sub(r"\s+\w+$", "", p.strip())]
                for p in params.split(",")]

    found = 0
    for kernel, params in re.findall(r"int (\w+)_##SUFFIX\(([^)]*)\)",
                                     body):
        assert kernel in bp.ARGTYPES, kernel
        assert types(params) == bp.ARGTYPES[kernel], kernel
        found += 1
    assert found == len(bp.KERNELS)
    cxx = {torch.float64: "double", torch.float32: "float",
           torch.bfloat16: "__nv_bfloat16"}
    # every kernel's entries for the first four pairs, the APC pair's
    # alone for the all-bf16 one
    assert re.findall(r"^REPRO_ENTRIES\((\w+), (\w+), (\w+)\)$", body,
                      re.M) == [(suffix, cxx[tm], cxx[t]) for (tm, t), suffix
                                in bp.pairs("cimmino_gather").items()]
    assert re.findall(r"^REPRO_APC_ENTRIES\((\w+), (\w+), (\w+)\)$",
                      body, re.M) == [
        (suffix, cxx[tm], cxx[t]) for (tm, t), suffix in bp.PAIRS.items()
        if (tm, t) not in bp.pairs("cimmino_gather")]
    assert all(bp.pairs(kn) == bp.PAIRS for kn in bp.ALL_BF16)
    assert [kn for kn in bp.KERNELS if re.search(
        rf"int {kn}_##SUFFIX", body[body.index("#define REPRO_APC_ENTRIES"):
                                    body.index("#define REPRO_ENTRIES")])
            ] == list(bp.ALL_BF16)
    # the ring's shared-memory query returns int64_t and takes the form
    (params,) = re.findall(r"int64_t gather_ring_smem\(([^)]*)\)", body)
    assert types(params) == bp.RING_SMEM_ARGTYPES
    assert params.split(",")[-1].split() == ["int64_t", "form"]
    assert "kApcForm = {apc}, kCimminoForm = {cimmino};".format(
        **bp.FORMS) in src
    # every kernel, the four gathers and the three scatters, takes its
    # instance and then its k-chunk as the two int64 before the stream
    assert sorted(bp.RINGS) == sorted(bp.KERNELS)
    for kernel in bp.KERNELS:
        (params,) = re.findall(rf"int {kernel}_##SUFFIX\(([^)]*)\)", body)
        has = [x.split() for x in params.split(",")[-3:-1]] == [
            ["int64_t", "instance"], ["int64_t", "kc"]]
        assert has == (kernel in bp.RINGS), kernel
        if has:
            assert bp.ARGTYPES[kernel][-3:] == [ctypes.c_int64] * 2 + [
                ctypes.c_void_p]
    assert "kRowDot = {row_dot}, kRing = {ring};".format(
        **bp.INSTANCES) in src
    # each of them has its ring kernel
    for kernel in bp.RINGS:
        assert f"{kernel}_ring_kernel(" in src, kernel


#: the operands gather_instance reads, by kernel form: apc_gather's
#: (A, X, X̄), cimmino_gather's (A, X̄), the sparse gathers' vals
#: (m, p, w) alone (they gather X and X̄ element by element), and the
#: scatters' matrix (B (m, n, p), or Bvals (m, w, p)) with the operand
#: they stage (V, or U, (m, k, p))
FORMS = {"apc": ("A", "X", "Xbar"), "cimmino": ("A", "Xbar"),
         "sparse": ("A",), "scatter": ("B", "V")}


def _gather_operands(n, dtype, m=2, p=3, k=4, form="apc"):
    """The operands of ``form``'s gather_instance, n the row length of
    the matrix: A (m, p, n) (the sparse form's vals, n its support
    width), X (m, k, n) as the transposed view solve_many hands the
    kernels, X̄ (k, n); a scatter's B (m, p, n) (p its rows, n its
    columns: the dense p, or w) and V (m, k, n) as the transposed view."""
    ops_ = dict(A=torch.empty((m, p, n), dtype=dtype),
                X=torch.empty((k, m, n), dtype=dtype).transpose(0, 1),
                Xbar=torch.empty((k, n), dtype=dtype),
                B=torch.empty((m, p, n), dtype=dtype),
                V=torch.empty((k, m, n), dtype=dtype).transpose(0, 1))
    return [ops_[name] for name in FORMS[form]]


def _offset(t):
    """A copy of t's shape whose data starts one element past an aligned
    base, as a view at an odd offset does."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n,dtype,want", [
    (16384, torch.float64, "ring"),      # the main path's A rows
    (2048, torch.float64, "ring"),       # its B (and Bvals) rows: p
    (128, torch.float32, "ring"),        # 512 bytes
    (130, torch.float64, "ring"),        # 1040 bytes
    (130, torch.float32, "row_dot"),     # 520 bytes: not a 16-byte multiple
    (7, torch.float32, "row_dot"),
    (7, torch.float64, "row_dot"),
    (6, torch.float64, "ring"),          # 48 bytes
    (6, torch.float32, "row_dot"),       # 24 bytes
    (0, torch.float64, "row_dot"),       # an empty row
])
def test_gather_instance_by_row_length(n, dtype, want, form):
    """The ring takes rows whose 16-byte pieces it can copy, the row dot
    the others; k = 1 and m = 1 strides do not count."""
    assert bp.gather_instance(*_gather_operands(n, dtype, form=form)) == want
    assert bp.gather_instance(*_gather_operands(n, dtype, m=1, k=1,
                                                form=form)) == want


@pytest.mark.parametrize("form,which", [
    (form, which) for form, names in FORMS.items() for which in names])
def test_gather_instance_misaligned_base_takes_the_row_dot(which, form):
    ops_ = dict(zip(FORMS[form], _gather_operands(16384, torch.float64,
                                                  form=form)))
    assert bp.gather_instance(*ops_.values()) == "ring"
    ops_[which] = _offset(ops_[which])
    assert bp.gather_instance(*ops_.values()) == "row_dot"


@pytest.mark.parametrize("form", ["apc", "cimmino", "scatter"])
def test_gather_instance_strides_count(form):
    """A batch row stride that is not a 16-byte multiple (an X, X̄ or
    V whose rows sit 129 f32 apart) takes the row dot, though the rows
    themselves are 512 bytes."""
    A = torch.empty((2, 3, 128), dtype=torch.float32)
    X = torch.empty((2, 4, 129), dtype=torch.float32)[..., :128]
    Xb = torch.empty((4, 128), dtype=torch.float32)
    if form == "apc":
        assert bp.gather_instance(A, X, Xb) == "row_dot"
        assert bp.gather_instance(A, X[:, :1], Xb[:1]) == "ring"   # k = 1
    elif form == "cimmino":
        Xw = torch.empty((4, 129), dtype=torch.float32)[:, :128]
        assert bp.gather_instance(A, Xw) == "row_dot"
        assert bp.gather_instance(A, Xw[:1]) == "ring"             # k = 1
        assert bp.gather_instance(A, Xb) == "ring"
    else:
        # V (m, k, p) in its rows of 129, and as the (m, k, p) view of a
        # (k, m, p) batch whose worker rows sit 129 apart
        assert bp.gather_instance(A, X) == "row_dot"
        # k = 1: the worker stride, 4·129 f32 = 2064 bytes, is a multiple
        assert bp.gather_instance(A, X[:, :1]) == "ring"
        Vt = torch.empty((4, 2, 129), dtype=torch.float32)[..., :128]
        assert bp.gather_instance(A, Vt.transpose(0, 1)) == "row_dot"
        assert bp.gather_instance(A, Vt[:1].transpose(0, 1)) == "row_dot"
        V = torch.empty((4, 2, 128), dtype=torch.float32)
        assert bp.gather_instance(A, V.transpose(0, 1)) == "ring"
        assert bp.gather_instance(A, V[:1].transpose(0, 1)) == "ring"
        assert bp.gather_instance(A, X[:1, :1]) == "ring"    # m = k = 1
    # the sparse gathers copy no operand row: vals alone decides
    assert bp.gather_instance(A) == "ring"


@pytest.mark.parametrize("form", FORMS)
def test_forced_instance(form):
    """``forced`` (the wrappers' ``_instance``) picks the row dot anywhere
    and the ring only where it fits; anything else raises."""
    fits = _gather_operands(16384, torch.float64, form=form)
    assert bp.gather_instance(*fits, forced="row_dot") == "row_dot"
    assert bp.gather_instance(*fits, forced="ring") == "ring"
    with pytest.raises(ValueError, match="row dot"):
        bp.gather_instance(*_gather_operands(130, torch.float32, form=form),
                           forced="ring")
    with pytest.raises(ValueError, match="unknown instance"):
        bp.gather_instance(*fits, forced="tensor_core")


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("matrix,operand,ring_at_k1", [
    (torch.float64, torch.float64, False),
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float64, True),
    (torch.bfloat16, torch.float32, True)])
def test_scatter_instance_at_k1_follows_the_dtype_pair(matrix, operand,
                                                       ring_at_k1, k):
    """A scatter's fixed rule: at k = 1 a float64 or float32 matrix takes
    the row dot though the ring fits, a bf16 one the ring; at k > 1 every
    pair takes the ring.  Forcing either instance still holds, and the
    gathers' operands (no ``scatter``) are not touched by the rule."""
    B = torch.empty((2, 5, 2048), dtype=matrix)              # (m, n, p)
    V = torch.empty((k, 2, 2048), dtype=operand).transpose(0, 1)
    want = "ring" if k > 1 or ring_at_k1 else "row_dot"
    assert bp.gather_instance(B, V, scatter=True) == want
    assert bp.gather_instance(B, V) == "ring"
    for forced in bp.INSTANCES:
        assert bp.gather_instance(B, V, forced=forced,
                                  scatter=True) == forced
    # rows the ring cannot copy take the row dot whatever the rule says
    assert bp.gather_instance(B[..., :7], V[..., :7],
                              scatter=True) == "row_dot"


@pytest.mark.parametrize("instance", [None, "ring", "row_dot"])
def test_gather_instance_argument_never_reaches_the_cpu(instance):
    """``_instance`` is keyword-only, and whatever it names, a CPU tensor
    still gets the launcher's refusal: no instance is a plain fallback
    (the gathers' and the scatters')."""
    A, B, X, Xb = (torch.as_tensor(a) for a in _inputs(4, 16, 2,
                                                        np.float64))
    cols = torch.arange(M * 16).reshape(M, 16) % 16
    U = torch.zeros(M, 2, 4, dtype=A.dtype)
    before = ops.launch_counts()
    launches = {
        "apc_gather": (bp.apc_gather, (A, X, Xb)),
        "cimmino_gather": (bp.cimmino_gather, (A, Xb)),
        "sparse_gather": (bp.sparse_gather, (A, cols, X, Xb)),
        "sparse_cimmino_gather": (bp.sparse_cimmino_gather, (A, cols, Xb)),
        "apc_scatter": (bp.apc_scatter, (B, X, Xb, U, 1.0)),
        "cimmino_scatter": (bp.cimmino_scatter, (B, U)),
        "sparse_scatter": (bp.sparse_scatter, (B, cols, U, X.clone())),
    }
    assert sorted(launches) == sorted(bp.RINGS)
    for launcher, args in launches.values():
        with pytest.raises(ValueError, match="CUDA"):
            launcher(*args, _instance=instance)
        with pytest.raises(TypeError):
            launcher(*args, instance)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("p,k,forced,want", [
    (8, 3, None, "ring"), (8, 3, "row_dot", "row_dot"),
    (8, 3, "ring", "ring"), (7, 3, None, "row_dot"),
    (7, 3, "ring", ValueError), (8, 1, None, "row_dot"),
    (8, 1, "ring", "ring")])
@pytest.mark.parametrize("kernel", bp.SCATTERS)
def test_scatter_launchers_pass_their_instance(monkeypatch, kernel, p, k,
                                               forced, want):
    """The scatters hand their C entry the instance that
    ``gather_instance(matrix, staged operand, scatter=True)`` picks (the
    row dot at k = 1 in float64), or the forced one, as the int64 before
    the k-chunk (0, the library's own, unless one is given) and the
    stream; forcing the ring on rows it cannot copy raises before any
    launch.  (The entries cannot run here: the device checks and the
    launch are stood in for.)"""
    calls = []

    def check(name, index=None, **operands):       # the sizes alone
        return {ax: n for t, axes in operands.values()
                for ax, n in zip(axes, t.shape)}

    monkeypatch.setattr(bp, "_check", check)
    monkeypatch.setattr(bp, "_launch", lambda name, matrix, out, *args:
                        calls.append((name, args)))
    B = torch.empty((2, 5, p), dtype=torch.float64)         # (m, n, p)
    V = torch.empty((k, 2, p), dtype=torch.float64).transpose(0, 1)

    def launch():
        if kernel == "apc_scatter":
            X = torch.empty((2, k, 5), dtype=B.dtype)
            return bp.apc_scatter(B, X, torch.empty((k, 5), dtype=B.dtype),
                                  V, 0.9, _instance=forced)
        if kernel == "cimmino_scatter":
            return bp.cimmino_scatter(B, V, _instance=forced)
        return bp.sparse_scatter(B, torch.zeros((2, 5), dtype=torch.int64),
                                 V, torch.empty((2, k, 9), dtype=B.dtype),
                                 _instance=forced)

    if want is ValueError:
        with pytest.raises(ValueError, match="row dot"):
            launch()
        assert calls == []
        return
    launch()
    ((name, args),) = calls
    assert name == kernel and args[-2:] == (bp.INSTANCES[want], 0)


def test_ring_smem_bytes_takes_the_form(monkeypatch):
    """``ring_smem_bytes`` hands the library the matrix's and the compute
    type's itemsizes, k and the form's int64; an unknown form raises
    before the library is asked."""
    asked = []

    class Lib:
        def gather_ring_smem(self, matrix_itemsize, itemsize, k, form):
            asked.append((matrix_itemsize, itemsize, k, form))
            return 1

    monkeypatch.setattr(bp, "_library", Lib)
    assert bp.ring_smem_bytes(torch.float64, torch.float64, 8,
                              "cimmino") == 1
    assert bp.ring_smem_bytes(torch.float32, torch.float32, 3, "apc") == 1
    assert bp.ring_smem_bytes(torch.bfloat16, torch.float64, 2, "apc") == 1
    assert asked == [(8, 8, 8, bp.FORMS["cimmino"]),
                     (4, 4, 3, bp.FORMS["apc"]), (2, 8, 2, bp.FORMS["apc"])]
    with pytest.raises(KeyError):
        bp.ring_smem_bytes(torch.float64, torch.float64, 8, "sparse")
    assert len(asked) == 3


@pytest.mark.parametrize("pair", list(bp.PAIRS))
def test_launch_counts_by_dtype_pair(monkeypatch, pair):
    """``_launch`` calls the C entry of the matrix's and the output's
    dtype pair and counts the launch under that pair alone:
    ``launch_counts(suffix)`` reads one pair, ``launch_counts()`` all of
    them, and an unknown suffix raises."""
    called = []

    class Lib:
        def __getattr__(self, entry):
            return lambda *args: called.append((entry, args)) or 0

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(bp, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(bp, "_launches", dict.fromkeys(bp._launches, 0))
    matrix_dtype, dtype = pair
    suffix = bp.PAIRS[pair]
    # a kernel with the pair's entries: the all-bf16 pair is the APC
    # kernels' alone
    kname = ("cimmino_scatter" if pair in bp.pairs("cimmino_scatter")
             else "apc_scatter")
    bp._launch(kname, torch.zeros(1, dtype=matrix_dtype),
               torch.zeros(1, dtype=dtype), 1, 2)
    bp._launch(kname, torch.zeros(1, dtype=matrix_dtype),
               torch.zeros(1, dtype=dtype), 3, 4)
    assert called == [(f"{kname}_{suffix}", (1, 2, 7)),
                      (f"{kname}_{suffix}", (3, 4, 7))]
    want = {kn: 2 if kn == kname else 0 for kn in bp.KERNELS}
    assert bp.launch_counts() == bp.launch_counts(suffix) == want
    for other in set(bp.PAIRS.values()) - {suffix}:
        assert bp.launch_counts(other) == dict.fromkeys(bp.KERNELS, 0)
    with pytest.raises(ValueError):
        bp.launch_counts("f16")
    bp.reset_launch_counts()
    assert bp.launch_counts(suffix) == dict.fromkeys(bp.KERNELS, 0)
