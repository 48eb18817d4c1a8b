"""Build, bind and launch the CUDA ``apc_gather``/``apc_scatter`` kernels.

Counterpart of ``repro.kernels.block_projection`` (the Pallas TPU pair).
The kernels live in ``csrc/block_projection.cu`` (see the note there for
their design); this module compiles them with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at first use, keyed by a
hash of the sources and flags, under ``build/repro_torch_kernels/`` in
the checkout, and calls them through ``ctypes`` on PyTorch's current
stream.

The launchers take CUDA tensors only; every check of device, dtype,
shape and strides happens here, before a pointer reaches the kernel.
They allocate their outputs with ``torch.empty``, launch on the
operands' device and its current stream, and raise on a nonzero
``cudaGetLastError()``.  Each launch adds one to its counter in
:func:`launch_counts`, so a run can show that it went through the
kernels.  The plain PyTorch versions and the device dispatch are in
``ops``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

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

KERNELS = ("apc_gather", "apc_scatter")
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}

_launches = dict.fromkeys(KERNELS, 0)
_libs: dict = {}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    """Set every launch counter back to 0."""
    for name in _launches:
        _launches[name] = 0


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
    """Compile each source into its own shared library, all ``nvcc``
    processes started together; returns {source: library path}.

    A library whose hash-keyed path exists is reused.  Each build writes
    a temporary file and renames it into place, so a concurrent build of
    the same sources never loads a half-written library.  The compiler's
    output is kept beside the library, with the suffix ``.log``.
    """
    nvcc = None
    procs, paths = [], {}
    for src in sources:
        text = (CSRC / src).read_bytes()
        key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        out = BUILD_ROOT / key.hexdigest()[:16] / (
            "lib" + pathlib.Path(src).stem + ".so")
        paths[src] = out
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = nvcc or _nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, out, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
#: ctypes argument types of each C entry (``<kernel>_f64``/``_f32``), in
#: the order of the extern "C" signatures in csrc/block_projection.cu
ARGTYPES = {
    # A, X, Xbar, U, m, p, n, k, sx_w, sx_k, sxb_k, su_w, su_k, stream
    "apc_gather": [_PTR] * 4 + [_I64] * 9 + [_PTR],
    # B, X, Xbar, U, gamma, Y, m, n, p, k, sx_w, sx_k, sxb_k, su_w, su_k,
    # sy_w, sy_k, stream
    "apc_scatter": [_PTR] * 4 + [ctypes.c_double, _PTR] + [_I64] * 11
    + [_PTR],
}


def _library() -> ctypes.CDLL:
    if "block_projection" in _libs:
        return _libs["block_projection"]
    lib = ctypes.CDLL(str(build()["block_projection.cu"]))
    for kernel, argtypes in ARGTYPES.items():
        for dt in _DTYPES.values():
            fn = getattr(lib, f"{kernel}_{dt}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _libs["block_projection"] = lib
    return lib


def _check(name: str, M: torch.Tensor, X: torch.Tensor, Xbar: torch.Tensor,
           rows_axis: int) -> None:
    """Shared launcher checks: CUDA tensors on one device, one supported
    dtype, a contiguous (m, ., .) matrix stack, unit-stride rows."""
    tensors = {"matrix": M, "X": X, "Xbar": Xbar}
    for label, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} is on {t.device}; the kernel "
                             f"takes CUDA tensors")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if M.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {M.dtype} unsupported; the kernel "
                        f"takes float64 or float32")
    if any(t.dtype != M.dtype for t in tensors.values()):
        raise TypeError(f"{name}: mixed dtypes "
                        f"{sorted({str(t.dtype) for t in tensors.values()})}"
                        f"; A/B, X and Xbar must share one dtype")
    if M.dim() != 3 or not M.is_contiguous():
        raise ValueError(f"{name}: the matrix stack must be a contiguous "
                         f"(m, ., .) tensor, got shape {tuple(M.shape)}")
    if X.dim() != 3 or Xbar.dim() != 2:
        raise ValueError(f"{name}: X must be (m, k, n) and Xbar (k, n)")
    m, k, n = X.shape
    if X.shape[0] != M.shape[0] or Xbar.shape != (k, n):
        raise ValueError(f"{name}: X {tuple(X.shape)} / Xbar "
                         f"{tuple(Xbar.shape)} do not match the matrix "
                         f"stack {tuple(M.shape)}")
    if M.shape[rows_axis] != n:
        raise ValueError(f"{name}: n={n} of X does not match the matrix "
                         f"stack {tuple(M.shape)}")
    if (n > 1 and (X.stride(2) != 1 or Xbar.stride(1) != 1)):
        raise ValueError(f"{name}: X and Xbar need unit stride along n")


def apc_gather(A: torch.Tensor, X: torch.Tensor,
               Xbar: torch.Tensor) -> torch.Tensor:
    """U = (X̄ − X)·Aᵀ for every worker, in one launch.

    A (m, p, n) contiguous; X (m, k, n) with unit stride along n (any
    worker/row strides); X̄ (k, n) shared by all workers.  Returns U
    (m, k, p), contiguous, in A's dtype.
    """
    _check("apc_gather", A, X, Xbar, rows_axis=2)
    m, p, n = A.shape
    k = X.shape[1]
    U = torch.empty((m, k, p), dtype=A.dtype, device=A.device)
    fn = getattr(_library(), f"apc_gather_{_DTYPES[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launches["apc_gather"] += 1
        err = fn(A.data_ptr(), X.data_ptr(), Xbar.data_ptr(), U.data_ptr(),
                 m, p, n, k, X.stride(0), X.stride(1), Xbar.stride(0),
                 U.stride(0), U.stride(1), stream)
    if err:
        raise RuntimeError(f"apc_gather launch failed: CUDA error {err}")
    return U


def apc_scatter(B: torch.Tensor, X: torch.Tensor, Xbar: torch.Tensor,
                U: torch.Tensor, gamma: float) -> torch.Tensor:
    """Y = X + γ((X̄ − X) − U·Bᵀ) for every worker, in one launch.

    B (m, n, p) contiguous; X (m, k, n) and U (m, k, p) with unit stride
    along their last axis; X̄ (k, n) shared by all workers; γ a Python
    float (a runtime kernel argument).  Y is allocated in X's layout.
    """
    _check("apc_scatter", B, X, Xbar, rows_axis=1)
    m, n, p = B.shape
    k = X.shape[1]
    if (not U.is_cuda or U.device != B.device or U.dtype != B.dtype
            or U.shape != (m, k, p) or (p > 1 and U.stride(2) != 1)):
        raise ValueError(f"apc_scatter: U must be a ({m}, {k}, {p}) "
                         f"{B.dtype} CUDA tensor with unit stride along p, "
                         f"got {tuple(U.shape)} {U.dtype} on {U.device}")
    Y = torch.empty_like(X)
    fn = getattr(_library(), f"apc_scatter_{_DTYPES[B.dtype]}")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launches["apc_scatter"] += 1
        err = fn(B.data_ptr(), X.data_ptr(), Xbar.data_ptr(), U.data_ptr(),
                 float(gamma), Y.data_ptr(), m, n, p, k, X.stride(0),
                 X.stride(1), Xbar.stride(0), U.stride(0), U.stride(1),
                 Y.stride(0), Y.stride(1), stream)
    if err:
        raise RuntimeError(f"apc_scatter launch failed: CUDA error {err}")
    return Y
