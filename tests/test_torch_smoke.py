"""chip_smoke.py's control flow, rehearsed on the CPU with a faked card.

The card is the only place the CUDA kernels execute, so a fault in the
script's own control flow (a name, a shape, a launch count, a layout the
launchers refuse) would otherwise show only there.  This test runs the whole
script at a tiny size with the card faked: ``torch.cuda`` reports one
device, tensors asked for on ``cuda`` stay on the CPU, and each
launcher of ``kernels.block_projection`` is replaced by a counting
stand-in that asserts the launcher's contract (matrix stacks contiguous,
the matrix and operand dtypes a pair the kernels take, a unit stride
along every operand's last axis, ``cols`` a contiguous int64 (m, w)
tensor, the scatter's output not aliasing X, a forced instance that
``gather_instance`` admits) and computes
its result row by row from the plain versions, storing the sparse
scatter's support columns as the kernel does.  ``torch.cuda.CUDAGraph``
and the streams are faked too (:func:`fake_cuda_graphs`): a capture
records the tensor operations of its body and leaves every tensor
that existed before it as it was, as a capture on the card runs nothing;
``replay()`` runs the recorded operations again on the same tensors.  So
the captured solves run here, and their launch counts come from the
replays.  It also checks that the script refuses to run without a card.
"""
import contextlib
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import device as dev  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _load_smoke().main() != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "CUDA device" in out.err


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Profile:
    """torch.profiler.profile on the faked card: a trace with no device
    time (the CPU build's profiler fails on every event of a faked
    card)."""

    def __init__(self, **_):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def key_averages(self):
        return []


def _written(func, args, kwargs):
    """The tensors ``func`` writes into (in place, or ``out=``)."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        yield from (t for t in pytree.tree_leaves(value)
                    if isinstance(t, torch.Tensor))


def _storage(t):
    return t.untyped_storage().data_ptr()


# what the card refuses inside a capture: a copy to the host
_HOST_SYNCS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.equal.default)


class _Graph:
    """torch.cuda.CUDAGraph on the faked card: ``ops`` are the tensor
    operations of its capture (between ``capture_begin`` and
    ``capture_end``), each with the tensors it was given and gave;
    ``replay()`` runs them again on those tensors (a view needs no work;
    an operation that made a new tensor writes its result into the one it
    made at capture), as a graph replays its kernels on the addresses
    they were captured with."""

    def __init__(self):
        self.ops = []
        self._capture = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        # a capture on the faked card records its own thread's operations
        # only (a dispatch mode is thread-local): "thread_local" mode
        assert capture_error_mode in ("global", "thread_local", "relaxed")
        self._capture = _Capture(self)
        self._capture.__enter__()

    def capture_end(self):
        capture, self._capture = self._capture, None
        capture.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            if func.is_view:
                continue
            got = func(*args, **kwargs)
            if next(_written(func, args, kwargs), None) is not None:
                continue                  # it wrote into its operands
            for old, new in zip(pytree.tree_leaves(out),
                                pytree.tree_leaves(got)):
                if isinstance(old, torch.Tensor):
                    old.copy_(new)


class _Capture(TorchDispatchMode):
    """A capture into ``g`` on the faked card: records every operation,
    and on exit puts back every tensor made before the capture that the
    body wrote into (a capture on the card writes nothing)."""

    def __init__(self, graph):
        super().__init__()
        self.graph, self.made, self.saved = graph, set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        assert func not in _HOST_SYNCS, f"{func}: a host sync in a capture"
        for t in _written(func, args, kwargs):
            if _storage(t) not in self.made:
                self.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        # new storage only: a view (or any alias) shares its input's
        given = {_storage(t) for t in pytree.tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        self.made.update(_storage(t) for t in pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor)
                         and _storage(t) not in given)
        self.graph.ops.append((func, args, kwargs, out))
        return out

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for t, before in reversed(self.saved):
            t.copy_(before)


class _Stream:
    """torch.cuda.Stream on the faked card: one queue, the CPU's."""

    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass


def fake_cuda_graphs(monkeypatch):
    """CUDA graphs, streams and the cuSOLVER preference on the faked card
    (the CPU build has none of them)."""
    for name, value in dict(
            CUDAGraph=_Graph, Stream=_Stream, current_device=lambda: 0,
            current_stream=lambda *a: _Stream(),
            stream=lambda s: contextlib.nullcontext()).items():
        monkeypatch.setattr(torch.cuda, name, value)
    # the CPU build refuses a cuSOLVER preference; the stand-in keeps it
    backend = ["default"]
    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library",
                        lambda b=None: backend.__setitem__(0, b) if b
                        else backend[0])


def _contract(name, matrix, operands, cols=None, kc=None):
    assert matrix.is_contiguous(), (name, "matrix stack not contiguous")
    assert len({t.dtype for t in operands}) == 1, name
    assert (matrix.dtype, operands[0].dtype) in bp.pairs(name), name
    assert kc is None or kc in bp.KC_VALUES, (name, kc)
    for t in operands:
        assert t.shape[-1] <= 1 or t.stride(-1) == 1, (name, t.stride())
    if cols is not None:
        assert cols.dtype == torch.int64 and cols.is_contiguous(), name
        assert cols.dim() == 2 and cols.shape[0] == matrix.shape[0], name
    bp.count_launch(name, bp.PAIRS[(matrix.dtype, operands[0].dtype)])


def _by_row(k, f):
    """A kernel's result: each batch row on its own, as the kernels
    compute it, so a batch row equals a k = 1 call."""
    return torch.cat([f(slice(i, i + 1)) for i in range(k)], dim=1)


def _fake_launchers():
    def apc_gather(A, X, Xb, *, kc=None, _instance=None):
        _contract("apc_gather", A, [X, Xb], kc=kc)
        bp.gather_instance(A, X, Xb, forced=_instance)
        return _by_row(Xb.shape[0], lambda i: ops.apc_gather_ref(
            A, X[:, i], Xb[i])).contiguous()

    def apc_scatter(B, X, Xb, U, gamma, *, kc=None, _instance=None):
        _contract("apc_scatter", B, [X, Xb, U], kc=kc)
        bp.gather_instance(B, U, forced=_instance, scatter=True)
        return _by_row(Xb.shape[0], lambda i: ops.apc_scatter_ref(
            B, X[:, i], Xb[i], U[:, i], gamma))

    def cimmino_gather(A, Xb, *, kc=None, _instance=None):
        _contract("cimmino_gather", A, [Xb], kc=kc)
        bp.gather_instance(A, Xb, forced=_instance)
        return _by_row(Xb.shape[0], lambda i: ops.cimmino_gather_ref(
            A, Xb[i])).contiguous()

    def cimmino_scatter(B, V, *, kc=None, _instance=None):
        _contract("cimmino_scatter", B, [V], kc=kc)
        bp.gather_instance(B, V, forced=_instance, scatter=True)
        return _by_row(V.shape[1], lambda i: ops.cimmino_scatter_ref(
            B, V[:, i])).contiguous()

    def sparse_gather(vals, cols, X, Xb, *, kc=None, _instance=None):
        _contract("sparse_gather", vals, [X, Xb], cols, kc)
        bp.gather_instance(vals, forced=_instance)
        return _by_row(Xb.shape[0], lambda i: ops.sparse_gather_ref(
            vals, cols, X[:, i], Xb[i])).contiguous()

    def sparse_cimmino_gather(vals, cols, Xb, *, kc=None, _instance=None):
        _contract("sparse_cimmino_gather", vals, [Xb], cols, kc)
        bp.gather_instance(vals, forced=_instance)
        return _by_row(Xb.shape[0], lambda i: ops.sparse_cimmino_gather_ref(
            vals, cols, Xb[i])).contiguous()

    def sparse_scatter(Bv, cols, U, out, *, X=None, Xbar=None, gamma=0.0,
                       kc=None, _instance=None):
        _contract("sparse_scatter", Bv,
                  [U, out] + ([] if X is None else [X, Xbar]), cols, kc)
        bp.gather_instance(Bv, U, forced=_instance, scatter=True)
        C = _by_row(U.shape[1], lambda i: torch.einsum(
            "mwp,mkp->mkw", Bv.to(U.dtype), U[:, i]))
        idx = cols[:, None, :].expand(out.shape[:-1] + (-1,))
        if X is not None:
            assert out.data_ptr() != X.data_ptr()
            x = torch.take_along_dim(X, idx, -1)
            xb = torch.take_along_dim(Xbar.expand(X.shape), idx, -1)
            C = x + gamma * ((xb - x) - C)
        return out.scatter_(-1, idx, C)          # the kernel stores

    return {f.__name__: f for f in (
        apc_gather, apc_scatter, cimmino_gather, cimmino_scatter,
        sparse_gather, sparse_cimmino_gather, sparse_scatter)}


def test_chip_smoke_runs_end_to_end_on_a_faked_card(monkeypatch, capsys,
                                                    tmp_path):
    smoke = _load_smoke()
    for name, value in dict(
            FULL=dict(N=256, n=128, m=4),
            SPARSE=dict(n=640, m=4, bandwidth=8),
            SPARSE_CORNERS=[dict(n=130, m=2, bandwidth=6),
                            dict(n=24, m=24, bandwidth=2)],
            LS_MID=dict(N=256, n=128, m=4, noise=0.5, seed=0),
            ITERS=40, LS_ITERS=900,
            smi=lambda: "NVIDIA H100 80GB HBM3, 700.00 W").items():
        monkeypatch.setattr(smoke, name, value)
    medians_ms = smoke.medians_ms
    monkeypatch.setattr(smoke, "medians_ms", lambda fns, reps=1, batch=1:
                        medians_ms(fns, reps=1, batch=1))
    as_tensor = torch.as_tensor

    def cpu_as_tensor(*a, **k):
        if str(k.get("device")) == "cuda":
            k["device"] = "cpu"
        return as_tensor(*a, **k)
    monkeypatch.setattr(torch, "as_tensor", cpu_as_tensor)
    monkeypatch.setattr(smoke, "randn", lambda seed, *shape,
                        dtype=torch.float64: torch.randn(
                            shape, generator=torch.Generator().manual_seed(
                                seed)).to(dtype))
    for name, value in dict(
            is_available=lambda: True, synchronize=lambda *a: None,
            empty_cache=lambda: None, device_count=lambda: 1,
            get_device_name=lambda *a: "NVIDIA H100 80GB HBM3",
            Event=_Event, reset_peak_memory_stats=lambda *a: None,
            memory_allocated=lambda *a: 0, memory_reserved=lambda *a: 0,
            max_memory_allocated=lambda *a: 0).items():
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(dev, "resolve", lambda d=None: torch.device("cpu"))
    on_cuda = ops._on_cuda
    monkeypatch.setattr(ops, "_on_cuda",
                        lambda op, *t: on_cuda(op, *t) or True)
    monkeypatch.setattr(ops, "on_cuda", lambda op, *t: True)
    lib = tmp_path / "libblock_projection.so"
    lib.write_text("")
    ring = ("ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__"
            "fa3dee60_19_block_projection_cu_8ac00be0{}I{}dLi8E{}EEvPKT_' for "
            "'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 168 registers, used 1 barriers, 128 bytes "
            "smem\n")
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121sparse_"
        "scatter_kernelIddLi8ELi2ELb1EEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes "
        "smem\n" + "".join(
            ring.format(f"{len(kn) + 12}{kn}_ring_kernel", tm,
                        "Lb1E" if kn == "sparse_scatter" else "")
            for kn in bp.RINGS for tm in ("d", "13__nv_bfloat16"))
        # the all-bf16 APC pair (its compute type mangled as "S0_"), both
        # instances
        + "".join(
            ring.format(f"{len(kn) + len(inst) + 7}{kn}{inst}_kernel",
                        "13__nv_bfloat16", "").replace(
                "bfloat16dLi8E", "bfloat16S0_Li8E")
            for kn in bp.ALL_BF16 for inst in ("", "_ring")))
    monkeypatch.setattr(bp, "build", lambda sources=bp.SOURCES: {
        "block_projection.cu": lib})
    # the two forms' stage sizes at KC = 8: (64 + 16) and (64 + 8) rows of
    # 512 bytes, 5 stages each (the scatters' rings: the Cimmino form)
    monkeypatch.setattr(bp, "ring_smem_bytes", lambda mdt, dt, k, form: {
        "apc": 204800, "cimmino": 184320}[form])
    for name, fn in _fake_launchers().items():
        monkeypatch.setattr(bp, name, fn)
    monkeypatch.setattr(bp, "_launches", dict.fromkeys(bp._launches, 0))

    assert smoke.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                         '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    text = "\n".join(lines)
    assert ("sparse_scatter f64 KC=8 apc spill 0 B: 128 regs, smem 16384 B; "
            "apc_gather_ring f64 KC=8 spill 0 B: 168 regs, smem 128 B + "
            "204800 B dynamic") in text
    # each ring's dynamic shared memory by its form
    assert ("cimmino_gather_ring f64 KC=8 spill 0 B: 168 regs, smem 128 B + "
            "184320 B dynamic") in text
    assert ("sparse_cimmino_gather_ring f64 KC=8 spill 0 B: 168 regs, smem "
            "128 B + 184320 B dynamic") in text
    assert ("cimmino_scatter_ring f64 KC=8 spill 0 B: 168 regs, smem 128 B "
            "+ 184320 B dynamic") in text
    assert ("sparse_scatter_ring f64 KC=8 apc spill 0 B: 168 regs, smem 128 "
            "B + 184320 B dynamic") in text
    # and the bf16-stored instances, tagged by their matrix/compute types
    assert ("apc_gather_ring bf16/f64 KC=8 spill 0 B: 168 regs, smem 128 B "
            "+ 204800 B dynamic") in text
    # both instances of the four gathers and the three scatters (both
    # forms of sparse_scatter) where the ring fits, the row dot alone where
    # it does not (f32 rows of 130, p = 7); a bf16-stored scatter's ring
    # equals the ring on the widened matrix
    scatters = ("apc_scatter", "cimmino_scatter", "sparse_scatter apc",
                "sparse_scatter cimmino")
    for kn in bp.GATHERS + scatters:
        assert f"{kn} ring≡row_dot" in text, kn
    for kn in scatters:
        assert any(f" bfloat16/float64: " in x and f"{kn} ring≡widened ring"
                   in x for x in lines), kn
    assert any("n=130" in x and "float32" in x and "apc_gather row_dot" in x
               and "apc_scatter row_dot" in x
               and "cimmino_gather row_dot" in x
               and "cimmino_scatter row_dot" in x for x in lines)
    # phases 8 and 11 time every gather's row-dot instance beside its ring
    # (float64), and each scatter's in every form
    for phase, kn, n in ((8, "apc_gather", 2), (8, "apc_scatter", 8),
                         (8, "cimmino_gather", 2),
                         (8, "cimmino_scatter", 8), (11, "sparse_gather", 2),
                         (11, "sparse_cimmino_gather", 2),
                         (11, "sparse_scatter", 16)):
        assert sum(x.startswith(f"phase {phase} {kn} k=")
                   and "row-dot instance" in x for x in lines) == n, kn
        # and each scatter's ring beside it, forced where the
        # launcher takes the row dot (k = 1, float64 and float32)
        assert sum(x.startswith(f"phase {phase} {kn} k=")
                   and "ring instance" in x for x in lines) == (
            n if kn in bp.SCATTERS else 0), kn
    assert sum(x.startswith("phase 11 sparse_scatter k=")
               and "(Cimmino form)" in x for x in lines) == 8
    # the card's clocks at the start and end of phases 8 and 11 (no
    # nvidia-smi here: the lines say so and the run goes on)
    for label in ("phase 8 start", "phase 8 end", "phase 11 start",
                  "phase 11 end"):
        assert sum(x.startswith(f"{label} clocks") for x in lines) == 1
    # phase 2 holds every kernel's mixed forms against the plain versions
    for pr in ("bfloat16/float64", "bfloat16/float32"):
        assert sum(x.startswith("phase 2 ") and f" {pr}: " in x
                   for x in lines) >= 8, pr
    # phase 12: the mixed path, dense and sparse, and its solve_many
    for half in ("dense", "sparse"):
        for sname in ("apc", "consensus", "cimmino"):
            assert sum(x.startswith(f"phase 12 {half} {sname} precision="
                                    "mixed:") and "upcast twin" in x
                       for x in lines) == 1, (half, sname)
    assert sum(x.startswith("phase 12 solve_many k=8 precision=mixed:")
               for x in lines) == 1
    # and in float32, the kernels' bfloat16/float32 and float32 forms
    for half in ("dense", "sparse"):
        for sname in ("apc", "cimmino"):
            for what in ("precision=mixed float32", "float32"):
                assert sum(x.startswith(f"phase 12 {half} {sname} {what}:")
                           for x in lines) == 1, (half, sname, what)
    # phases 8 and 11 time every kernel in every form (the float32 one
    # beside its library call) and the mixed iterations
    pairs = ("float64/float64", "float32/float32", "bfloat16/float64",
             "bfloat16/float32")
    for phase, kns in ((8, bp.KERNELS[:4]), (11, bp.KERNELS[4:])):
        for kn in kns:
            for pr in pairs:
                got = [x for x in lines if x.startswith(f"phase {phase} {kn} "
                                                        "k=")
                       and f" {pr}: " in x]
                assert len(got) == (4 if kn == "sparse_scatter" else 2), (
                    kn, pr)
                assert all(("torch." in x) == (pr[0] == "f") for x in got)
    assert sum(x.startswith("phase 8 iteration k=") and "precision=mixed" in x
               for x in lines) == 2
    assert sum(x.startswith("phase 11 iteration k=")
               and "precision=mixed" in x for x in lines) == 4
    # phase 13: every kernel-path solve captured and held to the eager
    # loop, DGD beside it, the solve times in turns, the idle share (no
    # device time in the faked profile: not measured), the executor
    for half in ("dense", "sparse"):
        for sname in ("apc", "consensus", "cimmino"):
            for precision in ("default", "mixed"):
                for k in (1, 8):
                    assert sum(x.startswith(
                        f"phase 13 {half} {sname} {precision} k={k}: "
                        "captured ≡ eager loop") for x in lines) == 1, (
                        half, sname, precision, k)
        assert sum(x.startswith(f"phase 13 {half} dgd k=")
                   and "bit-identical True" in x for x in lines) == 2
    assert sum(x.startswith("phase 13 ") and "whole solve" in x
               for x in lines) == 4 + 8
    assert sum(x.startswith("phase 13 dense apc k=") and " memory: " in x
               for x in lines) == 2
    assert sum(x.startswith("phase 13 sparse apc k=1 ")
               and "idle share not measured" in x for x in lines) == 4
    assert sum(x.startswith("phase 13 executor apc k=8")
               and "builds 1 captures 1 cache 1" in x for x in lines) == 1
    assert sum(x.startswith("phase 13 executor apc k=8")
               and "executor replay" in x for x in lines) == 1
    assert sum(x.startswith("phase 13 sparse apc k=1 ")
               and "graph's capture" in x for x in lines) == 2
    for phase in (8, 11):
        assert sum(x.startswith(f"phase {phase} iteration k=")
                   and " captured: " in x for x in lines) == 2, phase
    # phase 14: serving, dense and sparse, sync and async, the disk tier
    # and the CLIs; its launch counts come from the replays
    p14 = [x for x in lines if x.startswith("phase 14 ")]
    for label in ("fingerprint:", "dense apc server k=8",
                  "dense apc server:", "dense apc server memory:",
                  "one batch", "dense apc async", "overload",
                  "sparse apc precision=mixed", "sparse cimmino warm_start",
                  "disk tier"):
        assert sum(x.startswith(f"phase 14 {label}") for x in p14) == 1, (
            label, p14)
    assert any("store misses 1 hits 3; executor builds 1, captures 1" in x
               and "launches a batch [56, 40, 40, 40] (apc_gather)" in x
               for x in p14), p14
    assert any("launches 176 of each kernel" in x for x in p14), p14
    assert any("warm_batches 3; the warm program captured once" in x
               for x in p14), p14
    assert any("disk_hits 2 misses 0" in x for x in p14), p14
    assert any("two systems from a cold store" in x
               and "async bit-equal to sync for both" in x for x in p14), p14
    assert any(x.startswith("phase 14 serve_linsys --async: async pipeline")
               and "0 shed" in x for x in p14), p14
    assert any(x.startswith("phase 14 serve_linsys --async: factor store")
               and "disk_hits=2" in x for x in p14), p14
    assert any(x.startswith("phase 14 solve run 2: resuming from "
                            "checkpointed state at iter 200") for x in p14)
    kernels = json.loads(next(x for x in lines if x.startswith(
        '{"kernels"')))["kernels"]
    assert [k["name"] for k in kernels] == list(bp.KERNELS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "forms"}
    form_keys = {"pair", "k", "ms", "row_dot_ms", "ring_ms", "bound_ms",
                 "bound_by", "launches", "max_abs_err", "library_ms",
                 "library"}
    bf = "bfloat16/bfloat16"
    for k in kernels:
        assert set(k) == keys and k["launches"] == 40, k
        assert np.isfinite([k["ms"], k["plain_ms"], k["bound_ms"]]).all()
        # the APC pair's all-bf16 form beside the four others, its
        # launches from phase 15's ops.block_projection
        allbf = k["name"] in bp.ALL_BF16
        assert [f["pair"] for f in k["forms"]] == list(pairs) + [bf] * allbf
        # each form's count from its own runs
        assert [f["launches"] for f in k["forms"]] == [40] * 4 + [1] * allbf
        for f in k["forms"]:
            assert set(f) == form_keys and np.isfinite(f["ms"]), f
            assert (f["row_dot_ms"] is None) == (
                k["name"] not in bp.RINGS or (
                    k["name"] in bp.GATHERS and f is not k["forms"][0]
                    and f["pair"] != bf))
            assert (f["ring_ms"] is None) == (k["name"] not in bp.SCATTERS)
        assert np.isfinite(k["forms"][1]["library_ms"])
        for f in k["forms"][2:4]:
            assert f["library_ms"] is None
            assert f["library"].startswith("none")
        for f in k["forms"][4:]:
            assert np.isfinite([f["library_ms"], f["bound_ms"],
                                f["max_abs_err"]]).all(), f
            assert f["library"] is None and f["bound_by"] == "bytes", f
    # phase 15: the all-bf16 pair at k = 1 and 8 (every instance, then
    # its times) and end to end, the engine verdicts without a pin (the
    # faked card is the CPU: the heuristic), the solves under them, the
    # k-chunk pins
    p15 = [x for x in lines if x.startswith("phase 15 ")]
    for kn in bp.ALL_BF16:
        for k in (1, 8):
            got = [x for x in p15 if x.startswith(f"phase 15 {kn} k={k} ")]
            assert len(got) == 2 and "row_dot" in got[0] and (
                "torch.matmul bf16" in got[1]), got
    assert sum(x.startswith("phase 15 ops.block_projection k=")
               for x in p15) == 2
    engine = [x for x in p15 if x.startswith("phase 15 engine ")]
    assert len(engine) == 8 and all(
        "not measured (the heuristic)" in x for x in engine), engine
    for half in ("dense", "sparse"):
        for sname in ("apc", "cimmino"):
            assert sum(x.startswith(f"phase 15 {half} {sname} solve_many "
                                    "k=8 no pin: verdict fused")
                       for x in p15) == 1, (half, sname)
    assert any(x.startswith("phase 15 KC pins k=8")
               and "bit-equal across the pins True" in x
               and "a pin of 16 refused" in x for x in p15), p15
    for label in ("phase 15 start", "phase 15 end"):
        assert sum(x.startswith(f"{label} clocks") for x in lines) == 1
    assert [k["replaces"].rsplit(":", 1)[1] for k in kernels] == [
        "173", "210", "246", "274", "313", "314", "315"]
