"""Build, bind and launch the CUDA kernels of the projection family:
``apc_gather``/``apc_scatter``, ``cimmino_gather``/``cimmino_scatter``
and, over the compressed support of sparse systems, ``sparse_gather``,
``sparse_cimmino_gather`` and ``sparse_scatter``.

Counterpart of ``repro.kernels.block_projection`` (the Pallas TPU kernels).
The kernels live in ``csrc/block_projection.cu`` (see the note there for
their design); this module compiles them with ``nvcc`` for ``sm_90a``
at first use, once per dtype pair of :data:`PAIRS` (all the ``nvcc``
processes started together), into one shared library a pair with a
plain C interface, keyed by a hash of the source and flags, under
``build/repro_torch_kernels/`` in the checkout, and calls them through
``ctypes`` on PyTorch's current stream.

The launchers take CUDA tensors only; every check of device, dtype,
shape and strides happens here, before a pointer reaches the kernel.
They allocate their outputs with ``torch.empty``, launch on the
operands' device and its current stream, and raise on a nonzero
``cudaGetLastError()``.  Each launch adds one to its counter in
:func:`launch_counts`, kept per kernel and dtype pair, so a run can show
that it went through the kernels, and through which form of each.  A
launch captured into a CUDA graph runs at each replay of the graph, and
counts there (:func:`captured_launches`, :func:`add_launches`).
The plain PyTorch versions and the device dispatch are in ``ops``.

All seven kernels (the four gathers ``apc_gather``, ``sparse_gather``,
``cimmino_gather``, ``sparse_cimmino_gather``, and the three scatters
``apc_scatter``, ``cimmino_scatter``, ``sparse_scatter`` in both forms)
have two instances, one kernel each: the "ring" for Hopper (producer
warps streaming 16-byte copies through a shared-memory ring to consumer
warps), and the "row dot" for the shapes the ring cannot copy.  The
kernels with a bf16 matrix and float64 operands, the float64
``cimmino_scatter`` and the float64 sparse kernels (:data:`MMA_FORMS`)
run their products on the FP64 tensor cores, in both instances, and the
all-bf16 ``sparse_scatter`` on the bf16 ones (:data:`BF16_MMA_FORMS`).
The sparse gathers' launch is two kernels: a pre-pass
that writes their support operand (X̄ − X, or X̄, at each worker's
support columns, in the accumulation dtype) into a buffer the launcher
allocates, then the ring or the row dot over vals against it.
:func:`gather_instance` picks one by the operands' shape and alignment
(and, for a scatter, its kernel and dtype pair at k = 1), and both
count as the same kernel.

Each kernel takes its matrix (A, B, vals or Bvals) in a storage dtype
beside the compute dtype of the other operands, which is also its output
dtype and, but for bfloat16, its accumulation dtype (the reference's
``_acc_dtype`` follows X): float64/float64, float32/float32, the
bf16-stored forms of ``precision="mixed"``, bfloat16/float64 and
bfloat16/float32, and the all-bf16 form, bfloat16/bfloat16, which
accumulates in float32 and rounds each result to bfloat16.  Every
kernel has C entries for each of these pairs (:data:`PAIRS`).

Every launcher takes ``kc``, the k-chunk of its launch (the batch rows a
block carries: one of :data:`KC_VALUES`, the instances the library
holds; ``None`` for the library's own choice, the smallest that holds k
rows, at most 8).  ``ops`` passes a pinned or measured one
(``REPRO_KERNEL_BK``, ``ops.pick_tiles``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("block_projection.cu",)
# src/repro_torch/kernels/ -> the checkout root is three levels up
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
# -Xptxas=-v: the build log beside each library records every kernel's
# registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS = ("apc_gather", "apc_scatter", "cimmino_gather",
           "cimmino_scatter", "sparse_gather", "sparse_cimmino_gather",
           "sparse_scatter")
#: the gathers and the scatters, every kernel with a ring instance beside
#: the row dot
GATHERS = ("apc_gather", "cimmino_gather", "sparse_gather",
           "sparse_cimmino_gather")
SCATTERS = ("apc_scatter", "cimmino_scatter", "sparse_scatter")
RINGS = GATHERS + SCATTERS
#: the C entries' suffix of each (matrix dtype, compute dtype) pair the
#: kernels take: <kernel>_<suffix>, in the library of the pair, which
#: ``nvcc`` builds with -DREPRO_PAIR=<its place here>
PAIRS = {(torch.float64, torch.float64): "f64",
         (torch.float32, torch.float32): "f32",
         (torch.bfloat16, torch.float64): "bf16_f64",
         (torch.bfloat16, torch.float32): "bf16_f32",
         (torch.bfloat16, torch.bfloat16): "bf16_bf16"}
#: the k-chunks the library instantiates (csrc/block_projection.cu
#: with_kc)
KC_VALUES = (1, 2, 4, 8)
#: the kernels, by the suffix of their pair, whose products run on the
#: FP64 tensor cores: the kernels with a bf16 matrix and float64 operands
#: (csrc/block_projection.cu kMmaForm), the float64 ``cimmino_scatter``
#: (kMmaF64Form) and the float64 sparse kernels (kSparseMma), in a ring
#: of 256-row tiles whose sums stay in the mma fragment.  Both instances
#: of each sum in one order, so its ring and row dot are bit-identical.
MMA_FORMS = (("apc_gather", "bf16_f64"), ("apc_scatter", "bf16_f64"),
             ("cimmino_gather", "bf16_f64"), ("cimmino_scatter", "bf16_f64"),
             ("sparse_gather", "bf16_f64"),
             ("sparse_cimmino_gather", "bf16_f64"),
             ("sparse_scatter", "bf16_f64"),
             ("cimmino_scatter", "f64"), ("sparse_gather", "f64"),
             ("sparse_cimmino_gather", "f64"), ("sparse_scatter", "f64"))
#: the all-bf16 kernels whose products run on the bf16 tensor cores
#: (mma.sync m16n8k16, float32 sums; kBf16Mma), in the same 256-row ring:
#: ``sparse_scatter``, both forms.  Its two instances too are
#: bit-identical; the sums' order is the tensor cores', not the FFMA
#: rings'.
BF16_MMA_FORMS = (("sparse_scatter", "bf16_bf16"),)


#: the instances of the kernels in :data:`RINGS`, by the int64 their C
#: entries take (csrc/block_projection.cu kRowDot, kRing)
INSTANCES = {"row_dot": 0, "ring": 1}
#: the ring's forms, by the int64 gather_ring_smem takes (kApcForm,
#: kCimminoForm, kApcMmaForm, kCimminoMmaForm, kSparseForm,
#: kSparseScatterForm): the dense
#: APC gather stages X̄ and X, the dense Cimmino gather X̄, the scatters
#: U (or V), each in the Cimmino form's stage; the "_mma" forms are the
#: same stages in the layout of the FP64 tensor cores' consumer (the
#: bf16/float64 ``apc_gather``: "apc_mma"; the other dense bf16/float64
#: three and the float64 ``cimmino_scatter``: "cimmino_mma"; the library
#: answers 0 for any other pair); "sparse" is the two sparse gathers'
#: stage of their support operand, in its accumulation dtype, in the
#: layout of their consumer (:data:`MMA_FORMS`), for every pair;
#: "sparse_scatter" is ``sparse_scatter``'s, for every pair: in its
#: tensor-core forms (:data:`MMA_FORMS`, :data:`BF16_MMA_FORMS`) a
#: 256-row stage holding two units' operand rows (a tile may run from
#: one worker's rows into the next's), else the Cimmino form's
FORMS = {"apc": 0, "cimmino": 1, "apc_mma": 2, "cimmino_mma": 3,
         "sparse": 4, "sparse_scatter": 5}
# the ring's copies move 16 bytes between 16-byte-aligned addresses
_ALIGN = 16

#: launches so far, by (kernel, suffix of its dtype pair's C entry)
_launches = {(name, suffix): 0 for name in KERNELS
             for suffix in PAIRS.values()}
_libs: dict = {}


def launch_counts(pair: str | None = None) -> dict:
    """Kernel launches so far, by kernel name: of every dtype pair, or of
    the one whose C entries end in ``pair`` (a value of :data:`PAIRS`,
    "f64", "bf16_f64", ...)."""
    if pair is not None and pair not in PAIRS.values():
        raise ValueError(f"unknown dtype pair {pair!r}; expected one of "
                         f"{sorted(PAIRS.values())}")
    counts = dict.fromkeys(KERNELS, 0)
    for (name, suffix), n in _launches.items():
        if pair in (None, suffix):
            counts[name] += n
    return counts


def reset_launch_counts() -> None:
    """Set every launch counter back to 0."""
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


# the counts are shared by every thread (a serving pipeline launches from
# several); a capture holds back only its own thread's launches
_count_lock = threading.Lock()
_capture = threading.local()
# one build and load of the libraries, whichever thread launches first
_build_lock = threading.Lock()


def count_launch(name: str, suffix: str) -> None:
    """Count one launch of kernel ``name``'s C entry ``suffix``: into the
    capture under way on this thread (:func:`captured_launches`), if
    any, else into the counts."""
    held = getattr(_capture, "held", None)
    if held is not None:
        held[(name, suffix)] = held.get((name, suffix), 0) + 1
        return
    with _count_lock:
        _launches[(name, suffix)] += 1


@contextlib.contextmanager
def captured_launches():
    """Count the launches this thread makes inside as a CUDA graph's
    capture, which runs none of them: they stay out of the counts, in the
    dict this yields, by (kernel, pair), for :func:`add_launches` to add
    at each replay of the graph.  The counts then hold the launches the
    device ran, whatever other threads launch meanwhile.  ``ops``' engine
    and tile measurements run inside too: their launches on dummy
    operands are no launch of the path they choose for."""
    prev, held = getattr(_capture, "held", None), {}
    _capture.held = held
    try:
        yield held
    finally:
        _capture.held = prev


def add_launches(held: dict) -> None:
    """Add a replayed graph's launches (from :func:`captured_launches`)
    to the counts."""
    with _count_lock:
        for key, n in held.items():
            _launches[key] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def build(sources=SOURCES) -> dict:
    """Compile each source once per dtype pair of :data:`PAIRS` (with
    -DREPRO_PAIR=<the pair's place>) into a shared library of its own,
    all ``nvcc`` processes started together; returns {(source, suffix):
    library path}.

    A library whose hash-keyed path exists is reused.  Each build writes
    a temporary file and renames it into place, so a concurrent build of
    the same sources never loads a half-written library.  The compiler's
    output is kept beside the library, with the suffix ``.log``.
    """
    nvcc = None
    procs, paths = [], {}
    for src in sources:
        text = (CSRC / src).read_bytes()
        for i, suffix in enumerate(PAIRS.values()):
            flags = (*NVCC_FLAGS, f"-DREPRO_PAIR={i}")
            key = hashlib.sha256(text + " ".join(flags).encode())
            out = BUILD_ROOT / key.hexdigest()[:16] / (
                f"lib{pathlib.Path(src).stem}_{suffix}.so")
            paths[(src, suffix)] = out
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            nvcc = nvcc or _nvcc()
            cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / src)]
            procs.append((f"{src} {suffix}", tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for unit, tmp, out, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{unit}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
#: ctypes argument types of each C entry (``<kernel>_<suffix>``, every
#: suffix of :data:`PAIRS`), in the order of the extern "C" signatures in
#: csrc/block_projection.cu; ``kc`` 0 is the library's own k-chunk
ARGTYPES = {
    # A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k, su_w, su_k, instance,
    # kc, stream
    "apc_gather": [_PTR] * 4 + [_I64] * 11 + [_PTR],
    # B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w, sx_k, sxb_k, su_w, su_k,
    # sy_w, sy_k, instance, kc, stream
    "apc_scatter": [_PTR] * 4 + [ctypes.c_double, _PTR] + [_I64] * 13
    + [_PTR],
    # A, Xbar, U, m, p, n, k, sxb_k, su_w, su_k, instance, kc, stream
    "cimmino_gather": [_PTR] * 3 + [_I64] * 9 + [_PTR],
    # B, V, R, m, n, p, k, sv_w, sv_k, sr_w, sr_k, instance, kc, stream
    "cimmino_scatter": [_PTR] * 3 + [_I64] * 10 + [_PTR],
    # vals, cols, X, Xbar, U, O, m, p, w, wp, k, sx_w, sx_k, sxb_k, su_w,
    # su_k, instance, kc, stream (O: the support operand's buffer,
    # (m, k, wp))
    "sparse_gather": [_PTR] * 6 + [_I64] * 12 + [_PTR],
    # vals, cols, Xbar, U, O, m, p, w, wp, k, sxb_k, su_w, su_k, instance,
    # kc, stream
    "sparse_cimmino_gather": [_PTR] * 5 + [_I64] * 10 + [_PTR],
    # Bvals, cols, X, Xbar, U, gamma, Y, m, w, p, k, sx_w, sx_k, sxb_k,
    # su_w, su_k, sy_w, sy_k, instance, kc, stream (X and Xbar null: the
    # Cimmino form)
    "sparse_scatter": [_PTR] * 5 + [ctypes.c_double, _PTR] + [_I64] * 13
    + [_PTR],
}
#: the ring's dynamic shared memory query: (matrix itemsize, itemsize, k,
#: form) -> bytes
RING_SMEM_ARGTYPES = [_I64] * 4


def _library(suffix: str) -> ctypes.CDLL:
    """The library of the dtype pair whose C entries end in ``suffix``
    (every pair's is built at the first call)."""
    if suffix in _libs:
        return _libs[suffix]
    with _build_lock:
        if not _libs:
            for (_, sfx), path in build().items():
                lib = ctypes.CDLL(str(path))
                for kernel, argtypes in ARGTYPES.items():
                    fn = getattr(lib, f"{kernel}_{sfx}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.gather_ring_smem.argtypes = RING_SMEM_ARGTYPES
                lib.gather_ring_smem.restype = _I64
                _libs[sfx] = lib
    return _libs[suffix]


def ring_smem_bytes(matrix_dtype: torch.dtype, dtype: torch.dtype, k: int,
                    form: str) -> int:
    """Dynamic shared memory of the ring instance of ``form`` (a key of
    :data:`FORMS`) that a k-row batch launches, with its matrix in
    ``matrix_dtype`` and the compute type ``dtype``, in bytes (from the
    built library; 0 for an "_mma" form of another pair than
    bfloat16/float64, but "cimmino_mma" in float64)."""
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    form_id = FORMS[form]
    return int(_library(PAIRS[(matrix_dtype, dtype)]).gather_ring_smem(
        size(matrix_dtype), size(dtype), k, form_id))


def gather_instance(matrix: torch.Tensor, *copied: torch.Tensor,
                    forced: str = None, scatter: str = None) -> str:
    """The instance of a kernel of :data:`RINGS` for these operands:
    "ring" when every row it copies in 16-byte pieces is a non-empty
    16-byte multiple at a 16-byte-aligned address — the rows of
    ``matrix`` (A, vals, B or Bvals), and every base address and row
    stride of it and of the ``copied`` operands — else "row_dot".  The
    copied operands: ``apc_gather`` X and X̄; ``cimmino_gather`` X̄;
    ``cimmino_scatter`` V, ``apc_scatter`` and ``sparse_scatter`` U (the
    staged operand; the APC forms read X and X̄ element by element in
    their epilogue, and every scatter writes its output there); the sparse
    gathers copy their support operand, which their launcher allocates
    (:func:`support_buffer`), so none is named.  Each
    tensor's strides count in its own element size (a bf16 matrix beside
    float64 operands).  Strides of axes of size 1 are never used and do
    not count.

    ``scatter`` names the scatter (one of :data:`SCATTERS`) whose
    operands these are (``copied`` its staged V or U, (m, k, p)).  There
    one fixed rule on the kernel, the dtype pair and k comes on top: a
    dense scatter with a float64 or float32 matrix at k = 1 takes the
    row dot, which the chip timed ahead of the DFMA/FFMA ring in that
    case alone (PERF.md §6); a bf16 matrix, a form of :data:`MMA_FORMS`
    (the float64 ``cimmino_scatter``, whose row dot issues the ring's
    mmas from global memory and trails its ring), ``sparse_scatter``
    (every form's ring ahead of its row dot at the sparse path's shapes,
    PERF.md §6) or k > 1 takes the ring where it fits.

    ``forced`` names an instance to take instead (chip_smoke.py times
    both at the main path's shapes); forcing "ring" on operands it cannot
    take raises, as does an unknown name.  Decided by shape and dtype
    alone: no launch is tried and caught, and nothing is timed.
    """
    if forced is not None and forced not in INSTANCES:
        raise ValueError(f"unknown instance {forced!r}; expected one of "
                         f"{sorted(INSTANCES)}")
    if scatter is not None and scatter not in SCATTERS:
        raise ValueError(f"unknown scatter {scatter!r}; expected one of "
                         f"{SCATTERS}")
    tensors = (matrix, *copied)
    steps = [matrix.shape[-1] * matrix.element_size()] + [
        t.stride(i) * t.element_size() for t in tensors
        for i in range(t.dim() - 1) if t.shape[i] > 1]
    fits = matrix.shape[-1] > 0 and all(
        s % _ALIGN == 0 for s in steps) and all(
        t.data_ptr() % _ALIGN == 0 for t in tensors)
    if forced == "ring" and not fits:
        raise ValueError("the ring instance needs 16-byte rows, strides and "
                         "base addresses; these operands take the row dot")
    if forced:
        return forced
    if (scatter in ("apc_scatter", "cimmino_scatter")
            and matrix.dtype != torch.bfloat16
            and copied[0].shape[-2] == 1 and (scatter, PAIRS.get(
                (matrix.dtype, copied[0].dtype))) not in MMA_FORMS):
        return "row_dot"
    return "ring" if fits else "row_dot"


def _kc(kc) -> int:
    """The entries' kc argument: 0 (the library's own) for None, else one
    of :data:`KC_VALUES`."""
    if kc is None:
        return 0
    if kc not in KC_VALUES:
        raise ValueError(f"k-chunk {kc!r} is not instantiated; the kernels "
                         f"take KC in {KC_VALUES}")
    return int(kc)


def _check(name: str, index=None, **operands) -> dict:
    """Shared launcher checks; returns the size of every named axis.

    ``operands`` maps a label to ``(tensor, axes)``, ``axes`` naming each
    dimension ("mpn", "mkn", "kn", ...): every tensor must be on one CUDA
    device, the first operand (the matrix stack) in the matrix dtype and
    every other in one compute dtype, a pair of :data:`PAIRS`; every
    axis letter must bind to one size, the matrix stack must be
    contiguous and the others need a unit stride along their last axis.
    ``index`` is the sparse kernels' ``(cols, "mw")``: a contiguous int64
    tensor on the same device, whose axes bind like the others'.  Its
    values are not read here: ``0 <= cols < n`` is checked once, when the
    sparse system is built, not per launch.
    """
    if index is not None:
        cols = index[0]
        if cols.dtype != torch.int64 or not cols.is_contiguous():
            raise TypeError(f"{name}: cols must be a contiguous int64 "
                            f"tensor, got {cols.dtype} with strides "
                            f"{cols.stride()}")
        operands["cols"] = index
    tensors = {label: t for label, (t, _) in operands.items()}
    for label, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} is on {t.device}; the kernel "
                             f"takes CUDA tensors")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    matrix, *rest = [t for label, t in tensors.items() if label != "cols"]
    dtypes = {t.dtype for t in rest}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: operand dtypes "
                        f"{sorted(map(str, dtypes))}; every operand but "
                        f"the matrix must share one dtype")
    pair = (matrix.dtype, dtypes.pop())
    if pair not in PAIRS:
        raise TypeError(f"{name}: matrix {pair[0]} with operands {pair[1]} "
                        f"unsupported; the kernel takes "
                        + ", ".join(f"{a}/{b}" for a, b in PAIRS))
    sizes: dict = {}
    for i, (label, (t, axes)) in enumerate(operands.items()):
        if t.dim() != len(axes) or any(
                sizes.setdefault(ax, n) != n for ax, n in zip(axes, t.shape)):
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected "
                f"({', '.join(axes)}) with "
                f"{ {ax: sizes[ax] for ax in axes if ax in sizes} }")
        if i == 0 and not t.is_contiguous():
            raise ValueError(f"{name}: the matrix stack {label} must be "
                             f"contiguous")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: {label} needs a unit stride along "
                             f"its last axis")
    return sizes


def _launch(name: str, matrix: torch.Tensor, out: torch.Tensor,
            *args) -> None:
    """Launch the C entry of ``matrix``'s and ``out``'s dtype pair on
    their device's current stream, count it, and raise on a nonzero
    ``cudaGetLastError()``."""
    suffix = PAIRS[(matrix.dtype, out.dtype)]
    fn = getattr(_library(suffix), f"{name}_{suffix}")
    with torch.cuda.device(matrix.device):
        stream = torch.cuda.current_stream().cuda_stream
        count_launch(name, suffix)
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def apc_gather(A: torch.Tensor, X: torch.Tensor, Xbar: torch.Tensor, *,
               kc: int = None, _instance: str = None) -> torch.Tensor:
    """U = (X̄ − X)·Aᵀ for every worker, in one launch.

    A (m, p, n) contiguous; X (m, k, n) with unit stride along n (any
    worker/row strides); X̄ (k, n) shared by all workers.  Returns U
    (m, k, p), contiguous, in X's dtype.  The instance is
    ``gather_instance(A, X, Xbar)``, or ``_instance`` where given.
    """
    d = _check("apc_gather", A=(A, "mpn"), X=(X, "mkn"), Xbar=(Xbar, "kn"))
    instance = gather_instance(A, X, Xbar, forced=_instance)
    U = torch.empty((d["m"], d["k"], d["p"]), dtype=X.dtype, device=A.device)
    _launch("apc_gather", A, U, A.data_ptr(), X.data_ptr(),
            Xbar.data_ptr(), U.data_ptr(), d["m"], d["p"], d["n"], d["k"],
            X.stride(0), X.stride(1), Xbar.stride(0), U.stride(0),
            U.stride(1), INSTANCES[instance], _kc(kc))
    return U


def apc_scatter(B: torch.Tensor, X: torch.Tensor, Xbar: torch.Tensor,
                U: torch.Tensor, gamma: float, *, kc: int = None,
                _instance: str = None) -> torch.Tensor:
    """Y = X + γ((X̄ − X) − U·Bᵀ) for every worker, in one launch.

    B (m, n, p) contiguous; X (m, k, n) and U (m, k, p) with unit stride
    along their last axis; X̄ (k, n) shared by all workers; γ a Python
    float (a runtime kernel argument).  Y is allocated in X's layout.
    The instance is ``gather_instance(B, U, scatter="apc_scatter")``, or
    ``_instance`` where given.
    """
    d = _check("apc_scatter", B=(B, "mnp"), X=(X, "mkn"), Xbar=(Xbar, "kn"),
               U=(U, "mkp"))
    instance = gather_instance(B, U, forced=_instance, scatter="apc_scatter")
    Y = torch.empty_like(X)
    _launch("apc_scatter", B, Y, B.data_ptr(), X.data_ptr(),
            Xbar.data_ptr(), U.data_ptr(), float(gamma), Y.data_ptr(),
            d["m"], d["n"], d["p"], d["k"], X.stride(0), X.stride(1),
            Xbar.stride(0), U.stride(0), U.stride(1), Y.stride(0),
            Y.stride(1), INSTANCES[instance], _kc(kc))
    return Y


def cimmino_gather(A: torch.Tensor, Xbar: torch.Tensor, *, kc: int = None,
                   _instance: str = None) -> torch.Tensor:
    """U = X̄·Aᵀ for every worker, in one launch.

    A (m, p, n) contiguous; X̄ (k, n) with unit stride along n, shared by
    all workers.  Returns U (m, k, p), contiguous, in X̄'s dtype.  The
    instance is ``gather_instance(A, Xbar)``, or ``_instance`` where
    given.
    """
    d = _check("cimmino_gather", A=(A, "mpn"), Xbar=(Xbar, "kn"))
    instance = gather_instance(A, Xbar, forced=_instance)
    U = torch.empty((d["m"], d["k"], d["p"]), dtype=Xbar.dtype,
                    device=A.device)
    _launch("cimmino_gather", A, U, A.data_ptr(),
            Xbar.data_ptr(), U.data_ptr(), d["m"], d["p"], d["n"], d["k"],
            Xbar.stride(0), U.stride(0), U.stride(1), INSTANCES[instance],
            _kc(kc))
    return U


def cimmino_scatter(B: torch.Tensor, V: torch.Tensor, *, kc: int = None,
                    _instance: str = None) -> torch.Tensor:
    """R = V·Bᵀ for every worker, in one launch.

    B (m, n, p) contiguous; V (m, k, p) with unit stride along p (any
    worker/row strides, so the (m, k, p) view of a (k, m, p) batch goes
    in uncopied).  Returns R (m, k, n), contiguous, in V's dtype.  The
    instance is ``gather_instance(B, V, scatter="cimmino_scatter")``, or
    ``_instance`` where given.
    """
    d = _check("cimmino_scatter", B=(B, "mnp"), V=(V, "mkp"))
    instance = gather_instance(B, V, forced=_instance,
                               scatter="cimmino_scatter")
    R = torch.empty((d["m"], d["k"], d["n"]), dtype=V.dtype, device=B.device)
    _launch("cimmino_scatter", B, R, B.data_ptr(), V.data_ptr(),
            R.data_ptr(), d["m"], d["n"], d["p"], d["k"], V.stride(0),
            V.stride(1), R.stride(0), R.stride(1), INSTANCES[instance],
            _kc(kc))
    return R


def support_buffer(m: int, k: int, w: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """The sparse gathers' support operand buffer, (m, k, wp) in the
    accumulation dtype of ``dtype`` (float32 for bfloat16, else
    ``dtype``), its rows ``wp`` ≥ ``w`` elements, the smallest 16-byte
    multiple: the pre-pass writes X̄ − X (or X̄) at each worker's support
    columns into its first w columns and zeros past them."""
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    per = _ALIGN // acc.itemsize
    return torch.empty((m, k, -(-w // per) * per), dtype=acc, device=device)


def sparse_gather(vals: torch.Tensor, cols: torch.Tensor, X: torch.Tensor,
                  Xbar: torch.Tensor, *, kc: int = None,
                  _instance: str = None) -> torch.Tensor:
    """U = vals·(X̄ − X)[cols]ᵀ for every worker, in one launch of the
    entry: the pre-pass writes (X̄ − X)[cols] into a
    :func:`support_buffer`, then the ring or the row dot reads it.

    vals (m, p, w) contiguous; cols (m, w) contiguous int64 with values
    in [0, n); X (m, k, n) with unit stride along n (any worker/row
    strides); X̄ (k, n) shared by all workers.  Returns U (m, k, p),
    contiguous, in X's dtype.  The instance is ``gather_instance(vals)``,
    or ``_instance`` where given.
    """
    d = _check("sparse_gather", index=(cols, "mw"), vals=(vals, "mpw"),
               X=(X, "mkn"), Xbar=(Xbar, "kn"))
    instance = gather_instance(vals, forced=_instance)
    U = torch.empty((d["m"], d["k"], d["p"]), dtype=X.dtype,
                    device=vals.device)
    O = support_buffer(d["m"], d["k"], d["w"], X.dtype, vals.device)
    _launch("sparse_gather", vals, U, vals.data_ptr(),
            cols.data_ptr(), X.data_ptr(), Xbar.data_ptr(), U.data_ptr(),
            O.data_ptr(), d["m"], d["p"], d["w"], O.shape[-1], d["k"],
            X.stride(0), X.stride(1), Xbar.stride(0), U.stride(0),
            U.stride(1), INSTANCES[instance], _kc(kc))
    return U


def sparse_cimmino_gather(vals: torch.Tensor, cols: torch.Tensor,
                          Xbar: torch.Tensor, *, kc: int = None,
                          _instance: str = None) -> torch.Tensor:
    """U = vals·X̄[cols]ᵀ for every worker, in one launch of the entry:
    the pre-pass writes X̄[cols] into a :func:`support_buffer`, then the
    ring or the row dot reads it.

    vals (m, p, w) contiguous; cols (m, w) contiguous int64 with values
    in [0, n); X̄ (k, n) with unit stride along n.  Returns U (m, k, p),
    contiguous, in X̄'s dtype.  The instance is ``gather_instance(vals)``,
    or ``_instance`` where given.
    """
    d = _check("sparse_cimmino_gather", index=(cols, "mw"),
               vals=(vals, "mpw"), Xbar=(Xbar, "kn"))
    instance = gather_instance(vals, forced=_instance)
    U = torch.empty((d["m"], d["k"], d["p"]), dtype=Xbar.dtype,
                    device=vals.device)
    O = support_buffer(d["m"], d["k"], d["w"], Xbar.dtype, vals.device)
    _launch("sparse_cimmino_gather", vals, U, vals.data_ptr(),
            cols.data_ptr(), Xbar.data_ptr(), U.data_ptr(), O.data_ptr(),
            d["m"], d["p"], d["w"], O.shape[-1], d["k"], Xbar.stride(0),
            U.stride(0), U.stride(1), INSTANCES[instance], _kc(kc))
    return U


def sparse_scatter(Bvals: torch.Tensor, cols: torch.Tensor, U: torch.Tensor,
                   out: torch.Tensor, *, X: torch.Tensor = None,
                   Xbar: torch.Tensor = None, gamma: float = 0.0,
                   kc: int = None, _instance: str = None) -> torch.Tensor:
    """C = U·Bvalsᵀ for every worker, in one launch, stored into ``out``
    (m, k, n) at each worker's support columns; the other columns of
    ``out`` are left as they are.

    Cimmino form (no X): ``out[w, i, cols[w, j]] = C[w, i, j]``, ``out``
    zeroed by the caller.  APC form (X and X̄ given):
    ``out[w, i, c] = X + γ((X̄ − X) − C)`` at ``c = cols[w, j]``, ``out``
    holding the AXPY X + γ(X̄ − X) off the support; ``out`` must not
    alias X.  Both forms store, never add: a repeated index in ``cols``
    names an all-zero column, whose Bvals row is zero, so every copy
    stores the same value (checked when the sparse system is built).

    Bvals (m, w, p) contiguous; cols (m, w) contiguous int64; U, X and
    out with unit stride along their last axis (any worker/row strides);
    X̄ (k, n).  Returns ``out``.  The instance is
    ``gather_instance(Bvals, U, scatter="sparse_scatter")``, or
    ``_instance`` where given.
    """
    cimmino = X is None
    operands = dict(Bvals=(Bvals, "mwp"), U=(U, "mkp"), out=(out, "mkn"))
    if not cimmino:
        operands.update(X=(X, "mkn"), Xbar=(Xbar, "kn"))
        if out.data_ptr() == X.data_ptr():
            raise ValueError("sparse_scatter: out must not alias X")
    d = _check("sparse_scatter", index=(cols, "mw"), **operands)
    instance = gather_instance(Bvals, U, forced=_instance,
                               scatter="sparse_scatter")
    _launch("sparse_scatter", Bvals, out, Bvals.data_ptr(),
            cols.data_ptr(), None if cimmino else X.data_ptr(),
            None if cimmino else Xbar.data_ptr(), U.data_ptr(), float(gamma),
            out.data_ptr(), d["m"], d["w"], d["p"], d["k"],
            0 if cimmino else X.stride(0), 0 if cimmino else X.stride(1),
            0 if cimmino else Xbar.stride(0), U.stride(0), U.stride(1),
            out.stride(0), out.stride(1), INSTANCES[instance], _kc(kc))
    return out
