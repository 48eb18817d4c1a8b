"""The port's kernel ops against the JAX reference's Pallas ops.

On the CPU the port's ``proj_gather``/``proj_scatter``/``block_projection``
run their plain PyTorch versions; the reference's ops run their Pallas
kernels in interpret mode, as tests/test_kernels.py runs them.  Same
seeded inputs, the reference's tolerances (tests/test_kernels.py TOL,
relative to max|ref| + 1).  The CUDA kernels themselves are held against
the same plain versions on the card by chip_smoke.py.
"""
import contextlib
import pathlib

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
    all-CPU or all-CUDA operands of one dtype pair of
    ``block_projection.PAIRS``."""
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
                           torch.zeros(M, 4, dtype=torch.float16),
                           Xb.half())
    assert ops.launch_counts() == before


def test_ctypes_signatures_match_the_cuda_source():
    """The CUDA entries cannot be loaded here, so hold the ctypes
    argument types against the extern "C" signatures in the source."""
    import ctypes
    import re
    src = (bp.CSRC / "block_projection.cu").read_text()
    # the entries come from one macro, instantiated once per dtype pair,
    # each in a library of its own
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
    # every kernel's entries for every pair, the all-bf16 one included,
    # each pair under the -DREPRO_PAIR of its place in PAIRS
    assert re.findall(r"^#(?:el)?if REPRO_PAIR == (\d)\nREPRO_ENTRIES\("
                      r"(\w+), (\w+), (\w+)\)$", body, re.M) == [
        (str(i), suffix, cxx[tm], cxx[t])
        for i, ((tm, t), suffix) in enumerate(bp.PAIRS.items())]
    assert "REPRO_APC_ENTRIES" not in src
    # the ring's shared-memory query returns int64_t and takes the form
    (params,) = re.findall(r"int64_t gather_ring_smem\(([^)]*)\)", body)
    assert types(params) == bp.RING_SMEM_ARGTYPES
    assert params.split(",")[-1].split() == ["int64_t", "form"]
    # each form's int64 (kApcForm, kCimminoForm, kApcMmaForm,
    # kCimminoMmaForm, kSparseForm, kSparseScatterForm) as FORMS names it
    camel = {name: "".join(w.title() for w in name.split("_"))
             for name in bp.FORMS}
    assert {name: int(v) for name, v in re.findall(
        r"\bk(Apc\w*?|Cimmino\w*?|Sparse\w*?)Form = (\d+)", src)} == {
        camel[name]: v for name, v in bp.FORMS.items()}
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


@pytest.mark.parametrize("kernel", bp.SCATTERS)
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("matrix,operand,ring_at_k1", [
    (torch.float64, torch.float64, False),
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float64, True),
    (torch.bfloat16, torch.float32, True)])
def test_scatter_instance_at_k1_follows_the_dtype_pair(matrix, operand,
                                                       ring_at_k1, k,
                                                       kernel):
    """A scatter's fixed rule: at k = 1 a dense scatter's float64 or
    float32 matrix takes the row dot though the ring fits, but in a form
    of ``MMA_FORMS`` (the float64 ``cimmino_scatter``), and a bf16 one
    the ring; ``sparse_scatter`` takes the ring in every pair (its
    float64 and bf16/float64 forms on the FP64 tensor cores); at k > 1
    every pair takes the ring.  Forcing either instance still holds, the
    gathers' operands (no ``scatter``) are not touched by the rule, and
    an unknown scatter raises."""
    B = torch.empty((2, 5, 2048), dtype=matrix)              # (m, n, p)
    V = torch.empty((k, 2, 2048), dtype=operand).transpose(0, 1)
    mma = (kernel, bp.PAIRS[(matrix, operand)]) in bp.MMA_FORMS
    assert mma == (operand == torch.float64 and (
        matrix == torch.bfloat16
        or kernel in ("cimmino_scatter", "sparse_scatter")))
    want = ("ring" if k > 1 or ring_at_k1 or mma
            or kernel == "sparse_scatter" else "row_dot")
    assert bp.gather_instance(B, V, scatter=kernel) == want
    assert bp.gather_instance(B, V) == "ring"
    for forced in bp.INSTANCES:
        assert bp.gather_instance(B, V, forced=forced,
                                  scatter=kernel) == forced
    # rows the ring cannot copy take the row dot whatever the rule says
    assert bp.gather_instance(B[..., :7], V[..., :7],
                              scatter=kernel) == "row_dot"
    with pytest.raises(ValueError, match="unknown scatter"):
        bp.gather_instance(B, V, scatter="apc_gather")


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
    ``gather_instance(matrix, staged operand, scatter=name)`` picks (the
    row dot at k = 1 in float64, but the ring in ``cimmino_scatter``'s
    and ``sparse_scatter``'s tensor-core forms), or the forced one, as the
    int64 before
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
    if (p, k, forced) == (8, 1, None) and kernel != "apc_scatter":
        want = "ring"             # the float64 tensor-core forms at k = 1
    assert name == kernel and args[-2:] == (bp.INSTANCES[want], 0)


def test_build_compiles_a_library_a_pair_all_at_once(monkeypatch,
                                                     tmp_path):
    """``build`` starts one ``nvcc`` a dtype pair of ``PAIRS`` (the source
    with -DREPRO_PAIR=<its place>) before it waits for any, keeps each
    compiler's output beside its library, and reuses what exists."""
    started, waited = [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **_):
            started.append(cmd)
            self.out = pathlib.Path(cmd[cmd.index("-o") + 1])

        def communicate(self):
            waited.append(len(started))
            self.out.write_text("")
            return b"ptxas info", None

    monkeypatch.setattr(bp, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(bp, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(bp.subprocess, "Popen", Proc)
    paths = bp.build()
    assert list(paths) == [("block_projection.cu", sfx)
                           for sfx in bp.PAIRS.values()]
    assert [c[c.index("-o") - 1] for c in started] == [
        f"-DREPRO_PAIR={i}" for i in range(len(bp.PAIRS))]
    assert waited == [len(bp.PAIRS)] * len(bp.PAIRS)
    for (_, sfx), path in paths.items():
        assert path.name == f"libblock_projection_{sfx}.so"
        assert path.exists()
        assert path.with_suffix(".log").read_text() == "ptxas info"
    assert len({path.parent for path in paths.values()}) == len(bp.PAIRS)
    started.clear()
    assert bp.build() == paths and started == []


def test_ring_smem_bytes_takes_the_form(monkeypatch):
    """``ring_smem_bytes`` hands the library the matrix's and the compute
    type's itemsizes, k and the form's int64; an unknown form raises
    before the library is asked."""
    asked = []

    class Lib:
        def gather_ring_smem(self, matrix_itemsize, itemsize, k, form):
            asked.append((matrix_itemsize, itemsize, k, form))
            return 1

    libs = []
    monkeypatch.setattr(bp, "_library",
                        lambda suffix: libs.append(suffix) or Lib())
    assert bp.ring_smem_bytes(torch.float64, torch.float64, 8,
                              "cimmino") == 1
    assert bp.ring_smem_bytes(torch.float32, torch.float32, 3, "apc") == 1
    assert bp.ring_smem_bytes(torch.bfloat16, torch.float64, 2, "apc") == 1
    # the tensor-core form's stages: the APC gather's, the other three
    # bf16/float64 kernels', and the float64 Cimmino scatter's
    assert bp.ring_smem_bytes(torch.bfloat16, torch.float64, 8,
                              "apc_mma") == 1
    assert bp.ring_smem_bytes(torch.bfloat16, torch.float64, 1,
                              "cimmino_mma") == 1
    assert bp.ring_smem_bytes(torch.float64, torch.float64, 8,
                              "cimmino_mma") == 1
    # the sparse gathers' stage of their support operand, every pair;
    # sparse_scatter's, every pair
    assert bp.ring_smem_bytes(torch.bfloat16, torch.bfloat16, 8,
                              "sparse") == 1
    assert bp.ring_smem_bytes(torch.bfloat16, torch.bfloat16, 1,
                              "sparse_scatter") == 1
    assert asked == [(8, 8, 8, bp.FORMS["cimmino"]),
                     (4, 4, 3, bp.FORMS["apc"]), (2, 8, 2, bp.FORMS["apc"]),
                     (2, 8, 8, bp.FORMS["apc_mma"]),
                     (2, 8, 1, bp.FORMS["cimmino_mma"]),
                     (8, 8, 8, bp.FORMS["cimmino_mma"]),
                     (2, 2, 8, bp.FORMS["sparse"]),
                     (2, 2, 1, bp.FORMS["sparse_scatter"])]
    # each pair's library answers for its own pair
    assert libs == ["f64", "f32", "bf16_f64", "bf16_f64", "bf16_f64", "f64",
                    "bf16_bf16", "bf16_bf16"]
    with pytest.raises(KeyError):
        bp.ring_smem_bytes(torch.float64, torch.float64, 8, "dense")
    assert len(asked) == 8


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

    libs = []
    monkeypatch.setattr(bp, "_library",
                        lambda suffix: libs.append(suffix) or Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(bp, "_launches", dict.fromkeys(bp._launches, 0))
    matrix_dtype, dtype = pair
    suffix = bp.PAIRS[pair]
    # every kernel has every pair's entries
    kname = "cimmino_scatter"
    bp._launch(kname, torch.zeros(1, dtype=matrix_dtype),
               torch.zeros(1, dtype=dtype), 1, 2)
    bp._launch(kname, torch.zeros(1, dtype=matrix_dtype),
               torch.zeros(1, dtype=dtype), 3, 4)
    assert called == [(f"{kname}_{suffix}", (1, 2, 7)),
                      (f"{kname}_{suffix}", (3, 4, 7))]
    assert libs == [suffix, suffix]
    want = {kn: 2 if kn == kname else 0 for kn in bp.KERNELS}
    assert bp.launch_counts() == bp.launch_counts(suffix) == want
    for other in set(bp.PAIRS.values()) - {suffix}:
        assert bp.launch_counts(other) == dict.fromkeys(bp.KERNELS, 0)
    with pytest.raises(ValueError):
        bp.launch_counts("f16")
    bp.reset_launch_counts()
    assert bp.launch_counts(suffix) == dict.fromkeys(bp.KERNELS, 0)


def test_mma_forms_are_the_dense_bf16_f64_kernels_and_the_f64_cimmino_scatter():
    """The FP64 tensor-core form is every kernel with a bf16 matrix and
    float64 operands, the float64 Cimmino scatter and the float64 sparse
    kernels, and nothing else: ``MMA_FORMS`` names them, the source
    selects the first on the (bf16, double) pair of any kernel, the
    second on the (double, double) pair of a dense scatter without the
    APC epilogue, the third by kSparseMma (the sparse gathers, and
    sparse_scatter through kSparseScatterMma); the all-bf16
    ``sparse_scatter`` alone runs on the bf16 tensor cores
    (``BF16_MMA_FORMS``, kBf16Mma); and every form's stage query has its
    own int64."""
    src = (bp.CSRC / "block_projection.cu").read_text()
    dense = ("apc_gather", "apc_scatter", "cimmino_gather", "cimmino_scatter")
    sparse = ("sparse_gather", "sparse_cimmino_gather", "sparse_scatter")
    assert bp.MMA_FORMS == tuple((kn, "bf16_f64") for kn in dense + sparse) \
        + (("cimmino_scatter", "f64"),) + tuple((kn, "f64") for kn in sparse)
    assert bp.BF16_MMA_FORMS == (("sparse_scatter", "bf16_bf16"),)
    assert all(kn in bp.KERNELS and pair in bp.PAIRS.values()
               for kn, pair in bp.MMA_FORMS + bp.BF16_MMA_FORMS)
    assert ("constexpr bool kMmaForm = std::is_same_v<TM, __nv_bfloat16> "
            "&&\n                          std::is_same_v<T, double>;") in src
    assert ("constexpr bool kMmaF64Form = std::is_same_v<TM, double> &&\n"
            "                             std::is_same_v<T, double> && "
            "!kAxpy;") in src
    # the sparse kernels' FP64 consumer: kMmaForm's pair and the float64
    # one; sparse_scatter's adds the all-bf16 pair on the bf16 mma
    assert ("constexpr bool kSparseMma =\n    kMmaForm<TM, T> ||\n"
            "    (std::is_same_v<TM, double> && std::is_same_v<T, double>);"
            ) in src
    assert ("constexpr bool kBf16Mma = std::is_same_v<TM, __nv_bfloat16> &&\n"
            "                          std::is_same_v<T, __nv_bfloat16>;"
            ) in src
    assert ("constexpr bool kSparseScatterMma = kSparseMma<TM, T> || "
            "kBf16Mma<TM, T>;") in src
    # the dense scatters' rings take kMmaForm, the float64 form by the
    # scatter's epilogue too; sparse_scatter's ring, row dot and stage
    # kSparseScatterMma, on the span walk; the sparse gathers kSparseMma
    assert "constexpr bool kMma = kMmaForm<TM, T> && !kSparse;" in src
    assert "(kMmaF64Form<TM, T, kAxpy> && !kSparse)" in src
    assert "if constexpr (kSparse && kSparseScatterMma<TM, T>) {" in src
    assert "ring_run<TM, T, KC, false, true, true, true>(" in src
    assert src.count("kSparseScatterMma<TM, T>") >= 4
    assert src.count("kSparseMma<TM, T>") >= 4
    assert "bool kApc" not in src
    assert set(bp.FORMS) == {"apc", "cimmino", "apc_mma", "cimmino_mma",
                             "sparse", "sparse_scatter"}


@pytest.mark.parametrize("kernel", ["apc_gather", "apc_scatter",
                                    "cimmino_gather", "cimmino_scatter"])
@pytest.mark.parametrize("n,k,kc,offset,want,want_kc", [
    (2048, 8, None, False, "ring", 0),     # the main path's rows, k = 8
    (2048, 1, None, False, "ring", 0),     # k = 1: the ring (a bf16 matrix)
    (2048, 8, 4, False, "ring", 4),        # a pinned or measured k-chunk
    (2048, 3, 2, False, "ring", 2),
    (136, 5, None, False, "ring", 0),      # 272-byte bf16 rows
    (130, 8, None, False, "row_dot", 0),   # 260 bytes: not a multiple of 16
    (7, 1, None, False, "row_dot", 0),
    (2048, 8, None, True, "row_dot", 0),   # the matrix at an odd offset
])
def test_mma_form_instance_and_kc_by_shape(monkeypatch, kernel, n, k, kc,
                                           offset, want, want_kc):
    """The four dense bf16/float64 kernels take the ring wherever its
    16-byte copies fit the bf16 rows and the float64 operands' strides,
    at every k (a bf16 scatter takes the ring at k = 1 too), and the row
    dot of their form elsewhere; the launcher hands the entry that
    instance and the k-chunk (0: the library's own, kc_for(k)).  (The
    entries cannot run here: the device checks and the launch are stood
    in for.)"""
    calls = []

    def check(name, index=None, **operands):       # the sizes alone
        return {ax: size for t, axes in operands.values()
                for ax, size in zip(axes, t.shape)}

    monkeypatch.setattr(bp, "_check", check)
    monkeypatch.setattr(bp, "_launch", lambda name, matrix, out, *args:
                        calls.append((name, matrix.dtype, out.dtype,
                                      args)))
    m, rows = 2, 24
    M = torch.empty((m, rows, n), dtype=torch.bfloat16)
    if offset:
        M = _offset(M)
    gather = kernel.endswith("gather")
    X = torch.empty((k, m, n if gather else rows),
                    dtype=torch.float64).transpose(0, 1)
    Xb = torch.empty((k, X.shape[-1]), dtype=torch.float64)
    U = torch.empty((k, m, n), dtype=torch.float64).transpose(0, 1)
    launch = {"apc_gather": lambda kc: bp.apc_gather(M, X, Xb, kc=kc),
              "apc_scatter": lambda kc: bp.apc_scatter(M, X, Xb, U, 0.9,
                                                       kc=kc),
              "cimmino_gather": lambda kc: bp.cimmino_gather(M, Xb, kc=kc),
              "cimmino_scatter": lambda kc: bp.cimmino_scatter(M, U,
                                                               kc=kc)}[kernel]
    launch(kc)
    ((name, mdt, dt, args),) = calls
    assert (name, mdt, dt) == (kernel, torch.bfloat16, torch.float64)
    assert (name, bp.PAIRS[(mdt, dt)]) in bp.MMA_FORMS
    assert args[-2:] == (bp.INSTANCES[want], want_kc)
    with pytest.raises(ValueError, match="k-chunk"):
        launch(16 if gather else 3)


@pytest.mark.parametrize("w,dtype,acc,wp", [
    (2064, torch.float64, torch.float64, 2064),   # the sparse path's width
    (71, torch.float64, torch.float64, 72),       # an odd width, padded
    (71, torch.float32, torch.float32, 72),
    (71, torch.bfloat16, torch.float32, 72),      # all-bf16: float32
    (5, torch.float32, torch.float32, 8),
    (2, torch.float64, torch.float64, 2),
])
@pytest.mark.parametrize("kernel", ["sparse_gather", "sparse_cimmino_gather"])
def test_sparse_gathers_launch_with_their_support_buffer(monkeypatch, kernel,
                                                         w, dtype, acc, wp):
    """Each sparse gather's launch hands its entry a fresh support buffer
    (``support_buffer``: (m, k, wp) in the accumulation dtype, wp the
    smallest 16-byte multiple ≥ w) and wp beside w; the instance is
    vals' alone, and a bf16 matrix with float64 operands is a form of
    ``MMA_FORMS``, as is the float64 form.  (The entries cannot run
    here: the device checks and the launch are stood in for.)"""
    calls = []

    def check(name, index=None, **operands):       # the sizes alone
        return {ax: size for t, axes in operands.values()
                for ax, size in zip(axes, t.shape)}

    monkeypatch.setattr(bp, "_check", check)
    monkeypatch.setattr(bp, "_launch", lambda name, matrix, out, *args:
                        calls.append((name, matrix, out, args)))
    buffers = []
    real = bp.support_buffer
    monkeypatch.setattr(bp, "support_buffer", lambda *a: buffers.append(
        real(*a)) or buffers[-1])
    m, p, n, k = 2, 24, 300, 3
    mdt = torch.bfloat16 if dtype == torch.bfloat16 else dtype
    vals = torch.empty((m, p, w), dtype=mdt)
    cols = torch.zeros((m, w), dtype=torch.int64)
    X = torch.empty((k, m, n), dtype=dtype).transpose(0, 1)
    Xb = torch.empty((k, n), dtype=dtype)
    if kernel == "sparse_gather":
        U = bp.sparse_gather(vals, cols, X, Xb, kc=4)
    else:
        U = bp.sparse_cimmino_gather(vals, cols, Xb, kc=4)
    ((name, matrix, out, args),) = calls
    (O,) = buffers
    assert name == kernel and matrix is vals and out is U
    assert O.shape == (m, k, wp) and O.dtype == acc
    assert O.is_contiguous() and wp * O.element_size() % 16 == 0
    ptrs = 6 if kernel == "sparse_gather" else 5
    assert args[ptrs - 1] == O.data_ptr()
    assert args[ptrs:ptrs + 5] == (m, p, w, wp, k)
    assert args[-2:] == (bp.INSTANCES[bp.gather_instance(vals)], 4)
    assert len(args) + 1 == len(bp.ARGTYPES[kernel])
    for pair in ((torch.bfloat16, torch.float64),
                 (torch.float64, torch.float64)):
        assert (kernel, bp.PAIRS[pair]) in bp.MMA_FORMS


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("form", ["apc", "cimmino"])
@pytest.mark.parametrize("k,kc", [(1, None), (3, 2), (8, None)])
@pytest.mark.parametrize("pair", list(bp.PAIRS), ids=list(bp.PAIRS.values()))
def test_sparse_scatter_launch_by_pair_k_form_and_alignment(
        monkeypatch, pair, k, kc, form, aligned):
    """``sparse_scatter`` hands its pair's C entry the ring wherever the
    rows of Bvals and U are 16-byte multiples, at every k (k = 1 too) and
    in every pair: the float64 and bf16/float64 forms on the FP64 tensor
    cores (``MMA_FORMS``), the all-bf16 one on the bf16 tensor cores
    (``BF16_MMA_FORMS``), float32 and bf16/float32 on the FFMA ring; an
    odd p takes the row dot.  Beside it the k-chunk (0: the library's
    own), the pointers (X and X̄ null in the Cimmino form), the sizes
    (m, w, p, k) and the strides, as many and in the order of
    ``ARGTYPES``.  (The entries cannot run here: the device checks and
    the launch are stood in for.)"""
    calls = []

    def check(name, index=None, **operands):       # the sizes alone
        return {ax: size for t, axes in operands.values()
                for ax, size in zip(axes, t.shape)}

    monkeypatch.setattr(bp, "_check", check)
    monkeypatch.setattr(bp, "_launch", lambda name, matrix, out, *args:
                        calls.append((name, matrix, out, args)))
    mdt, dt = pair
    m, w, n = 2, 24, 300
    p = 2048 if aligned else 2047            # an odd row: no 16 bytes
    Bv = torch.empty((m, w, p), dtype=mdt)
    cols = torch.zeros((m, w), dtype=torch.int64)
    U = torch.empty((k, m, p), dtype=dt).transpose(0, 1)
    out = torch.empty((k, m, n), dtype=dt).transpose(0, 1)
    X = torch.empty((k, m, n), dtype=dt).transpose(0, 1)
    Xb = torch.empty((k, n), dtype=dt)
    kw = dict(X=X, Xbar=Xb, gamma=0.9) if form == "apc" else {}
    assert bp.sparse_scatter(Bv, cols, U, out, kc=kc, **kw) is out
    ((name, matrix, o, args),) = calls
    assert (name, matrix, o) == ("sparse_scatter", Bv, out)
    assert len(args) + 1 == len(bp.ARGTYPES["sparse_scatter"])
    apc = form == "apc"
    assert args[:7] == (Bv.data_ptr(), cols.data_ptr(),
                        X.data_ptr() if apc else None,
                        Xb.data_ptr() if apc else None, U.data_ptr(),
                        0.9 if apc else 0.0, out.data_ptr())
    assert args[7:11] == (m, w, p, k)
    assert args[11:18] == ((X.stride(0), X.stride(1), Xb.stride(0)) if apc
                           else (0, 0, 0)) + (U.stride(0), U.stride(1),
                                              out.stride(0), out.stride(1))
    want = "ring" if aligned else "row_dot"
    assert args[-2:] == (bp.INSTANCES[want], kc or 0)
    sfx = bp.PAIRS[pair]
    assert (("sparse_scatter", sfx) in bp.MMA_FORMS) == (
        dt == torch.float64)
    assert (("sparse_scatter", sfx) in bp.BF16_MMA_FORMS) == (
        dt == torch.bfloat16)


# Stand-ins for the two CUDA headers the kernel source includes: enough
# for libclang to parse it as CUDA device code without a toolkit.
_CUDA_RUNTIME_STUB = r"""
#pragma once
#include <stddef.h>
#include <stdint.h>
#define __global__ __attribute__((global))
#define __device__ __attribute__((device))
#define __host__ __attribute__((host))
#define __shared__ __attribute__((shared))
#define __forceinline__ __attribute__((always_inline))
#define __launch_bounds__(...) __attribute__((launch_bounds(__VA_ARGS__)))
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
struct dim3 {
  unsigned x, y, z;
  __host__ __device__ dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern __device__ uint3 threadIdx, blockIdx;
extern __device__ dim3 gridDim, blockDim;
struct uint4 { unsigned x, y, z, w; };
struct double2 { double x, y; };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
union cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int);
template <typename F, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, F, A...);
cudaError_t cudaGetLastError();
int cudaConfigureCall(dim3, dim3, size_t = 0, cudaStream_t = 0);
__device__ void __syncthreads();
__device__ void __syncwarp(unsigned = 0xffffffffu);
template <typename T>
__device__ T __shfl_xor_sync(unsigned, T, int);
__device__ float __uint_as_float(unsigned);
__device__ float __fadd_rn(float, float);
__device__ float __fsub_rn(float, float);
__device__ float __fmul_rn(float, float);
__host__ __device__ unsigned long long __cvta_generic_to_shared(const void*);
__device__ double fma(double, double, double);
__device__ float fma(float, float, float);
"""
_CUDA_BF16_STUB = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 {
  unsigned short x;
  __host__ __device__ __nv_bfloat16() {}
  __host__ __device__ __nv_bfloat16(float);
  __host__ __device__ operator float() const;
};
__device__ float __bfloat162float(__nv_bfloat16);
__device__ __nv_bfloat16 __float2bfloat16_rn(float);
"""


def _libclang_errors(cindex, path, include, resource, pair):
    """libclang's error diagnostics of the CUDA source at ``path``
    compiled for the device with -DREPRO_PAIR=``pair``, against the stub
    headers in ``include``: (line, message) pairs."""
    tu = cindex.Index.create().parse(str(path), args=[
        "-x", "cuda", "--cuda-device-only", "-nocudainc", "-nocudalib",
        "--cuda-gpu-arch=sm_90a", "-std=c++17", f"-I{include}", "-isystem",
        resource, f"-DREPRO_PAIR={pair}"])
    return [(d.location.line, d.spelling) for d in tu.diagnostics
            if d.severity >= cindex.Diagnostic.Error]


@pytest.mark.parametrize("pair", range(len(bp.PAIRS)),
                         ids=list(bp.PAIRS.values()))
def test_cuda_source_parses_without_errors_for_every_pair(tmp_path, pair):
    """``block_projection.cu`` has no template, deduction or type error
    in any pair's library: libclang parses it as CUDA device code for
    sm_90a with -DREPRO_PAIR=<the pair's place in PAIRS>, against stub
    CUDA headers, and reports no error — while the same source with one
    call's template arguments cut short (the compute type dropped from
    sparse_scatter's ring kernel, which every pair's entry launches)
    reports one, so the parse does check the kernels' instantiations.
    Skips without the libclang bindings or a C compiler's own headers."""
    import shutil
    import subprocess
    cindex = pytest.importorskip("clang.cindex")
    try:
        cindex.Index.create()
    except Exception as e:                      # no loadable libclang
        pytest.skip(f"libclang does not load: {e}")
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        pytest.skip("no C compiler for stddef.h's directory")
    resource = subprocess.run([cc, "-print-file-name=include"],
                              capture_output=True, text=True).stdout.strip()
    if not (pathlib.Path(resource) / "stddef.h").exists():
        pytest.skip(f"{cc} names no directory with stddef.h")
    (tmp_path / "cuda_runtime.h").write_text(_CUDA_RUNTIME_STUB)
    (tmp_path / "cuda_bf16.h").write_text(_CUDA_BF16_STUB)
    src = bp.CSRC / "block_projection.cu"
    assert _libclang_errors(cindex, src, tmp_path, resource, pair) == []
    call = "launch_ring<&sparse_scatter_ring_kernel<TM, T, KC, decltype"
    text = src.read_text()
    assert text.count(call) == 1
    broken = tmp_path / "broken.cu"
    broken.write_text(text.replace(call, call.replace("TM, T, KC", "TM, KC")))
    assert _libclang_errors(cindex, broken, tmp_path, resource, pair)
