#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one stdout line (or a few) each; any failure raises and the
script exits non-zero without its last line:

1. environment: versions, the card's name and power limit, TF32 off, and
   the CUDA kernels built from the checkout's sources, with each
   instance's registers, shared memory and spill bytes (none allowed in
   the ring instances that compute in float64, the bf16-stored ones
   included, and each of the seven rings present);
2. kernel vs plain version on the card: ``apc_gather``/``apc_scatter``
   and ``cimmino_gather``/``cimmino_scatter`` against their plain PyTorch
   versions at ragged shapes and at the main path's shapes, and
   ``sparse_gather``/``sparse_cimmino_gather``/``sparse_scatter`` at the
   reference's sparse corner shapes (odd support width, p = 1, even), a
   support width of one chunk and a bit, and the sparse path's shapes;
   float64 and float32, each with its matrix in its own dtype and in
   bfloat16 (the mixed forms), k = 1..11, a batch row bit-identical to a
   k = 1 call; both instances of each of the four gathers, of
   ``apc_scatter``, of ``cimmino_scatter`` and of both forms of
   ``sparse_scatter`` (the ring, where its alignment admits the shape,
   and the row dot) against the plain version and bit-identical to each
   other (a bf16-stored scatter's ring to the ring on its matrix widened,
   as its row dot sums in another order);
3. the APC main path at full size: a 32768 x 16384 tall Gaussian system
   on 16 workers (float64), ``analyze``, then ``solve`` on the kernel
   path — error to x_true, one launch of each kernel per iteration, the
   history against the unfused path, and a bit-identical repeat;
4. APC ``solve_many`` with 8 right-hand sides through the same kernels;
5. block Cimmino and consensus on the same system: ``solve`` on the
   kernel path (exactly one launch of each of its kernels per iteration,
   at k = 1), the history against the unfused path, a bit-identical
   repeat, and Cimmino ``solve_many`` with 8 right-hand sides;
6. the paper's comparison: all eight solvers for the same number of
   iterations, with parameters from ONE spectral analysis (X and AᵀA);
   final residual, iters_to_tol, theoretical and measured rate;
7. the CLI entry point ``repro_torch.launch.solve`` in-process, for
   ``--method apc`` and ``--method cimmino``, both with ``--use-kernel``;
8. CUDA-event times of each dense kernel in each of its forms
   (float64, float32, bf16/float64, bf16/float32), timed in turns beside
   each form's bound: the float64 form's plain version, one torch.matmul
   of the same product where the matrix and the operands share a dtype,
   the row-dot instance of a gather (float64) and of ``apc_scatter`` and
   ``cimmino_scatter`` (every form, each beside its ring forced), with
   the ring asserted to be the instance the main path's shapes take (but
   a float64 or float32 scatter at k = 1: the row dot); and of the whole
   APC and Cimmino iterations,
   float64 and mixed, eager and inside a captured 10-step CUDA graph,
   with the card's clocks, power, temperature and
   throttle reasons at the phase's start and end;
9. the sparse path at full size: a banded 32768 x 32768 system on 16
   workers (float64, support width 2064), one spectral analysis, then
   APC, consensus and Cimmino on the sparse kernels — exactly one launch
   of each of its kernels per iteration, the history against the
   unfused sparse path, x against the densified system's dense-kernel
   solve, a bit-identical repeat — and APC and Cimmino ``solve_many``
   with 8 right-hand sides;
10. least squares: the CLI on ``tall_noisy`` (Cimmino on its kernels,
   DGD), an 8192 x 4096 noisy system solved by Cimmino and DGD against
   each solver's ``ls_reference``, and the CLI on ``banded`` with APC on
   the sparse kernels;
11. CUDA-event times of the sparse kernels as in phase 8 (torch.bmm on
   the pre-gathered operands; both forms of ``sparse_scatter``, each
   with its row-dot instance in every form), and of the sparse and
   densified iterations and the sparse mixed ones (the sparse ones also
   in a captured 10-step graph), with the card's clocks as in phase 8,
   then the ``{"kernels": [...]}`` line with all seven, each with its
   forms;
12. ``precision="mixed"`` (bf16-stored A and B, float64 x), in two
   halves: after phase 7 on the dense system and after phase 9 on the
   sparse one, APC, consensus and Cimmino — exactly one launch of each
   of its kernels per iteration, a bit-identical repeat, the history of
   the "upcast twin" (the default solve on the bf16-rounded factors
   widened to float64, through the float64 kernels) within 1e-9, and the
   float64 run's within the reference's bf16 envelope — and dense APC
   ``solve_many`` with 8 right-hand sides; then APC and Cimmino on a
   float32 copy of each system, default (the kernels' float32 form) and
   mixed (bf16/float32);
13. compile-once execution (every ``solve``/``solve_many`` above already
   ran its history captured into a CUDA graph), in two halves: after
   phase 8 on the dense system and after phase 11 on the sparse one,
   APC, consensus and Cimmino on the kernels, default and mixed, k = 1
   and K_MANY — the captured histories and x ``torch.equal`` to the eager
   loop's (``executor.disable_capture``), 150 launches of each kernel
   counted from the replays, the kernel instances the capture took those
   of the eager loop, a bit-identical repeat — and DGD (cuBLAS glue)
   within 1e-12; the whole solve's time per iteration, eager against
   captured, in turns (host clock around work ending in synchronize());
   the dense solves' peak memory, eager and captured; the device's idle
   share over one sparse k = 1 APC solve, float64 and mixed, eager and
   captured (``torch.profiler``); and a ``LocalExecutor`` serving three
   batches of new right-hand sides of the sparse system — one build, one
   capture, the second and third runs quiet under
   ``tracecheck(steady_state=True)``, the first batch's x intact after
   the third, each batch against ``solve_many``;
14. serving (after phase 13): the dense main path regenerated and served
   by ``LinsysServer`` over a ``FactorStore`` (APC on the kernels, k =
   K_MANY, 29 seeded consistent right-hand sides: 4 batches, 3 pad
   slots) — 1 store miss then 3 hits, 1 executor build and 1 capture,
   batches 2-4 quiet under ``tracecheck(steady_state=True)``, 150
   launches of each kernel a steady batch from the replays, the
   placement the store's entry (no second copy of A or B), peak memory,
   each x within 1e-12 of ``solve_many`` and 1e-8 of x_true, RHS/s, ms a
   batch, the fingerprint's time, and one batch split into the
   executor's cold run (``init`` eagerly, outside the graph, then the
   graph) and warm run (the graph alone), and ``init`` alone on the
   process's own linalg library, cuSOLVER and MAGMA; the same traffic
   through ``AsyncLinsysServer`` (bit-equal, 0 shed, latency
   p50/p95/p99) and an overload (``admit_capacity``, explicit ``Shed``);
   APC at ``precision="mixed"`` on the sparse system and a second one
   (its rows doubled) from a cold store, requests interleaved, through
   both servers (bf16 store entries in each, bit-equal: the async
   server's second miss runs while the first system's program is
   captured), a warm Cimmino server on perturbed right-hand sides (the
   warm program captured once), and the disk tier under ``build/`` (a
   fresh store: two disk hits, x bit-equal, write and read times); the
   ``serve_linsys``
   CLI sync and ``--async`` on one ``--store-dir`` (the second run a disk
   hit) and the solve CLI with ``--ckpt-dir``/``--resume`` twice;
15. the kernel ops layer (after phase 14, with the card's clocks as in
   phase 8): (a) the all-bf16 ``apc_gather``/``apc_scatter`` at the dense
   main path's shapes, k = 1 and K_MANY, every instance
   ``gather_instance`` admits against the plain version (8e-2 of
   max|plain| + 1), timed beside the bytes bound, the plain version and
   ``torch.matmul`` in bf16, and ``ops.block_projection`` all-bf16 end to
   end; (b) the measured engine verdict (``ops.use_fused``, no pin) of the
   four families at the dense and sparse main path's shapes, k = 1 and
   K_MANY, with both times, then APC and Cimmino ``solve_many`` (k =
   K_MANY, 150 iterations) on each system with no pin: the kernels
   launched exactly where the verdict says fused, and the history within
   1e-6 relative of the pinned-fused one; (c) each k-chunk pin
   (``REPRO_KERNEL_BK`` 1, 2, 4, 8) on a K_MANY gather and scatter of the
   main path against the plain version, timed in turns, the outputs of
   the pins compared bit for bit, and the measured KC.

Every other phase runs under ``REPRO_KERNEL_ENGINE=fused``, the pin the
reference's own benchmarks use: the kernels those phases hold, count
and time run whatever the measured engine verdict would choose.

Every time is the median over rounds of a run of back-to-back calls
between two CUDA events, divided by the run's length: the host's time
to launch a call then overlaps the card's work on the one before.

The last line is ``{"ok": true, "device": {...}}``.  Imports only torch,
numpy and repro_torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FULL = dict(N=32768, n=16384, m=16)     # the main path's system
ITERS = 150
K_MANY = 8
CLI_ARGS = ["--problem", "ash608", "--workers", "4", "--iters", "200",
            "--use-kernel"]
# kernel vs plain: max|Δ| / (max|plain| + 1), tests/test_kernels.py TOL,
# by the compute dtype (a bf16 matrix is widened exactly)
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
BF16 = torch.bfloat16
# precision="mixed" against the float64 run: the reference's bf16
# envelope (tests/test_kernel_corners.py MIXED_TOL); against its upcast
# twin: 1e-9 absolute
MIXED_TOL = dict(rtol=0.5, atol=5e-2)
TWIN_TOL = 1e-9
# the default solve in float32 against the float64 run: about 80 float32
# epsilons absolute (the residual's own rounding is some 6 of them), so a
# float32 history that stalls or converges at another rate fails
F32_TOL = dict(rtol=1e-3, atol=1e-5)
# the kernels' (matrix, compute) dtype forms beside float64/float64
MIXED_FORMS = ((BF16, torch.float64), (BF16, torch.float32))
NO_LIBRARY = ("none: torch.matmul and torch.bmm refuse a bfloat16 matrix "
              "with float64 or float32 operands, and upcasting first is "
              "a second pass over the matrix")
RAGGED = [(7, 130), (1, 128), (24, 896)]
# the sparse path's system, and the banded corner systems of phase 2
# (tests/test_kernel_corners.py, plus a support one chunk and a bit wide)
SPARSE = dict(n=32768, m=16, bandwidth=8)
SPARSE_CORNERS = [dict(n=130, m=2, bandwidth=6), dict(n=24, m=24, bandwidth=2),
                  dict(n=192, m=4, bandwidth=6),
                  dict(n=1024, m=4, bandwidth=8)]
LS_MID = dict(N=8192, n=4096, m=8, noise=0.5, seed=0)
LS_ITERS = 600
# (HBM bytes/s, float64, float32 and dense bf16 peak op/s) from NVIDIA's
# data sheets, matched on the name nvidia-smi reports; the first match
# wins
CARDS = [("H100 PCIe", 2.0e12, 51e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 67e12, 989e12),
         ("H100", 3.35e12, 67e12, 67e12, 989e12)]
# the all-bf16 form against its plain version: tests/test_kernels.py's
# bf16 TOL, relative to max|plain| + 1
BF16_TOL = 8e-2
BF = "bfloat16/bfloat16"
ENGINE_ENV, BK_ENV = "REPRO_KERNEL_ENGINE", "REPRO_KERNEL_BK"
SOURCE = "src/repro_torch/kernels/csrc/block_projection.cu"
REPLACES = {"apc_gather": "src/repro/kernels/block_projection.py:173",
            "apc_scatter": "src/repro/kernels/block_projection.py:210",
            "cimmino_gather": "src/repro/kernels/block_projection.py:246",
            "cimmino_scatter": "src/repro/kernels/block_projection.py:274",
            "sparse_gather": "src/repro/kernels/block_projection.py:313",
            "sparse_cimmino_gather":
                "src/repro/kernels/block_projection.py:314",
            "sparse_scatter": "src/repro/kernels/block_projection.py:315"}
# the kernels each kernel-path solver launches, once per iteration
USES = {"apc": ("apc_gather", "apc_scatter"),
        "consensus": ("apc_gather", "apc_scatter"),
        "cimmino": ("cimmino_gather", "cimmino_scatter")}
SPARSE_USES = {"apc": ("sparse_gather", "sparse_scatter"),
               "consensus": ("sparse_gather", "sparse_scatter"),
               "cimmino": ("sparse_cimmino_gather", "sparse_scatter")}


def say(*parts) -> None:
    print(*parts, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


CLOCK_QUERY = ("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
               "clocks_throttle_reasons.active")


def clocks(label: str) -> None:
    """Print the card's SM clock, its maximum, power draw, temperature
    and active throttle reasons on a line of its own, so a change of
    rate within a run shows beside the times it would move.  Gates
    nothing: without nvidia-smi it says so and goes on."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={CLOCK_QUERY}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        got = (r.stdout + r.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        got = f"nvidia-smi not available ({e})"
    say(f"{label} clocks ({CLOCK_QUERY}): {got}")


def card_rates(name: str):
    for key, bw, f64, f32, b16 in CARDS:
        if key in name:
            return bw, {torch.float64: f64, torch.float32: f32,
                        torch.bfloat16: b16}
    raise RuntimeError(f"no bandwidth/peak entry for card {name!r}")


@contextlib.contextmanager
def env_var(name: str, value):
    """The environment variable ``name`` set to ``value`` (removed for
    None) inside, as it was after."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def randn(seed: int, *shape, dtype=torch.float64) -> torch.Tensor:
    """Seeded standard normals made on the card (a host array of the main
    path's size takes seconds to fill), in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|Δ| / (max|want| + 1), max|Δ|)"""
    d = float((got.double() - want.double()).abs().max())
    return d / (float(want.double().abs().max()) + 1.0), d


def pair_label(matrix: torch.Tensor, x: torch.Tensor) -> str:
    """'float64/float64', 'bfloat16/float64', ...: a kernel's form."""
    return f"{str(matrix.dtype)[6:]}/{str(x.dtype)[6:]}"


# the mangled matrix/compute types of a kernel instance, and their names
# (a substitution, "S<n>_", for the compute type: it repeats the matrix
# type, the all-bf16 form)
MANGLED = {"d": (torch.float64, "f64"), "f": (torch.float32, "f32"),
           "13__nv_bfloat16": (BF16, "bf16")}


def ptxas_summary(log: str, dynamic_smem) -> list[str]:
    """'apc_gather f64 KC=8 spill 0 B: 128 regs, smem 16384 B' per kernel
    instance, from nvcc's -Xptxas=-v output ('bf16/f64' for a bf16-stored
    matrix with float64 compute; the sparse scatter's two forms are tagged
    apc/cimmino; a ring instance's shared memory adds
    ``dynamic_smem(matrix dtype, dtype, KC, form)`` bytes of dynamic
    shared memory, the form "apc" for the APC gathers' rings, else
    "cimmino": the Cimmino gathers' and the scatters' stage)."""
    out, kernel = [], None
    for line in log.splitlines():
        hit = re.search(r"entry function '\S*?((?:apc|cimmino|sparse)_\w+?)"
                        r"_kernelI(d|f|13__nv_bfloat16)([df]|S\d*_)Li(\d+)E"
                        r"(?:Li\d+E)?(?:Lb([01]))?", line)
        if hit:
            mdtype, mname = MANGLED[hit[2]]
            dtype, name = MANGLED.get(hit[3], (mdtype, mname))
            tag = name if mname == name else f"{mname}/{name}"
            kernel = (f"{hit[1]} {tag} KC={hit[4]}"
                      + ("" if hit[5] is None else
                         " apc" if hit[5] == "1" else " cimmino"))
            ring = hit[1].endswith("_ring")
            form = ("apc" if hit[1] in ("apc_gather_ring",
                                        "sparse_gather_ring")
                    else "cimmino")
            kc = int(hit[4])
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and spill:
            kernel += f" spill {spill[1]} B"
        regs = re.search(r"Used (\d+) registers", line)
        if kernel and regs:
            smem = re.search(r"(\d+) bytes smem", line)
            kernel += f": {regs[1]} regs, smem {smem[1] if smem else 0} B"
            if ring:
                kernel += (f" + {dynamic_smem(mdtype, dtype, kc, form)} B "
                           f"dynamic")
            out.append(kernel)
            kernel = None
    return out


def medians_ms(fns: dict, reps: int = 15, batch: int = 10) -> dict:
    """CUDA-event medians, ms a call, of each function in ``fns``, timed
    in turns (f1, f2, ..., f1, f2, ...): a sample is a run of ``batch``
    back-to-back calls between two events, over ``batch``.  One call
    between two events would also time the host's launch of it, as the
    card idles until the launch arrives (phase 11 prints how much)."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / batch)
    return {name: float(np.median(t)) for name, t in times.items()}


def inputs(m, p, n, k, dtype, seed, *, transposed=False):
    """Seeded A (m,p,n), B (m,n,p), X (m,k,n), X̄ (k,n), V (m,k,p) on the
    card.

    ``transposed`` gives X and V as the (m, k, .) views of (k, m, .)
    tensors, the layout solve_many hands the kernels."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                   device="cuda").to(dtype)
    A, B = g(m, p, n), g(m, n, p)
    if transposed:
        X, V = g(k, m, n).transpose(0, 1), g(k, m, p).transpose(0, 1)
    else:
        X, V = g(m, k, n), g(m, k, p)
    return A, B, X, g(k, n), V


def decay(res: torch.Tensor, floor: float = 1e-12):
    """Measured per-step residual decay over the second half of the
    history above ``floor``: (r_j / r_i)^(1/(j-i)), or None."""
    r = res.double().cpu().numpy()
    above = np.nonzero(r > floor)[0]
    if len(above) < 4:
        return None
    j = int(above[-1])
    i = j // 2
    return float((r[j] / r[i]) ** (1.0 / (j - i)))


def timed_ms(fn):
    """(fn(), host ms from the card idle to the card idle after it)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


@contextlib.contextmanager
def linalg_library(lib: str):
    """``torch.backends.cuda.preferred_linalg_library(lib)`` inside."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(lib)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def captured_stdout(fn, label, card):
    """Run ``fn()`` with its standard output captured; print each line
    after ``label``, and the card it ran on after it.  Returns (fn(), the
    output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"{label}: {line} [{card}]")
    return out, text


def consistent(system, count, seed):
    """``count`` seeded solutions xs (on the card) and their right-hand
    sides A xs on the host, as a client sends them."""
    xs = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (count, system.n)), device="cuda")
    B = (system.A_blocks.reshape(system.N, system.n) @ xs.T).T
    return xs, B.cpu().numpy()


def groups(rhs, k):
    """The server's batches of ``rhs``: FIFO groups of k, the last padded
    by repeating its last request."""
    out = []
    for i in range(0, len(rhs), k):
        rows = list(rhs[i:i + k])
        out.append(np.stack(rows + [rows[-1]] * (k - len(rows))))
    return out


def serving_phase(card, form_launches, dprm, sp, sp_pinned) -> None:
    """Phase 14: ``LinsysServer`` and ``AsyncLinsysServer`` over a
    ``FactorStore`` on the dense main path and the sparse path, the disk
    tier, and the two CLIs (module docstring)."""
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_linsys as serve_cli
    from repro_torch.launch import solve as solve_cli
    from repro_torch.solvers import executor
    from repro_torch.solvers.pipeline import Shed

    s = solvers.get("apc")
    head = min(executor.CHUNK, ITERS)
    uses = lambda kns, n: {kn: n if kn in kns else 0  # noqa: E731
                           for kn in bp.KERNELS}

    # -- the dense main path, sync ---------------------------------------
    t = time.time()
    dsys = linsys.tall_gaussian(**FULL, seed=0, device="cuda")
    torch.cuda.synchronize()
    a_bytes = dsys.A_blocks.numel() * dsys.A_blocks.element_size()
    n_req = 3 * K_MANY + 5
    xs, rhs = consistent(dsys, n_req, 14)
    say(f"phase 14 data: tall_gaussian N={dsys.N} n={dsys.n} m={dsys.m} "
        f"float64 in {time.time() - t:.2f} s; {n_req} right-hand sides")
    fp_key, fp_ms = timed_ms(lambda: solvers.fingerprint("apc", dsys, dprm))
    say(f"phase 14 fingerprint: A {a_bytes / 1e9:.2f} GB copied from the "
        f"card and hashed (sha256) on the host in {fp_ms:.1f} ms "
        f"({a_bytes / fp_ms / 1e6:.2f} GB/s) [{card}]")
    store = solvers.FactorStore()
    srv = solvers.LinsysServer(store, solver="apc", iters=ITERS,
                               batch=K_MANY, use_kernel=True, **dprm)
    fp = srv.register(dsys)
    assert fp == fp_key
    for b in rhs:
        srv.submit(fp, b)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs, ms, launched = [], [], []
    ops.reset_launch_counts()
    with tracecheck() as tc:
        out, t_ms = timed_ms(srv.step)
    launched.append(form_launches("f64"))
    outs.append(out)
    ms.append(t_ms)
    resident = torch.cuda.memory_allocated()
    first_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tracecheck(steady_state=True):
        for _ in range(3):
            ops.reset_launch_counts()
            out, t_ms = timed_ms(srv.step)
            launched.append(form_launches("f64"))
            outs.append(out)
            ms.append(t_ms)
    steady_peak = torch.cuda.max_memory_allocated()
    assert srv.step() == []
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"], tc.summary()
    (ex,) = srv._executors.values()
    st = store.stats
    assert (st.misses, st.hits, st.disk_hits) == (1, 3, 0), st
    assert srv.stats.executor_builds == 1, srv.stats
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1)
    assert (srv.stats.served, srv.stats.padded, srv.stats.batches) == (
        n_req, 3, 4), srv.stats
    assert launched[0] == uses(USES["apc"], head + ITERS), launched[0]
    for got in launched[1:]:
        assert got == uses(USES["apc"], ITERS), got
    # one copy of A and of B: the placement IS the store's entry
    entry, ent = store._mem[fp], srv._systems[fp]
    assert entry.A is dsys.A_op and ent.A_placed is dsys.A_op
    assert ent.factors_placed is entry
    b_bytes = entry.B.numel() * entry.B.element_size()
    assert resident - base < a_bytes + b_bytes, (resident, base)
    assert steady_peak - resident < a_bytes // 4, (steady_peak, resident)
    served = [r for out in outs for r in out]
    assert [r.rid for r in served] == list(range(n_req))
    worst, same, err = 0.0, True, 0.0
    kfs = solvers.ExecutionPlan(kernel=True, factors=entry)
    for i, (Bg, out) in enumerate(zip(groups(rhs, K_MANY), outs)):
        ref = s.solve_many(dsys, Bg, iters=ITERS, plan=kfs, **dprm)
        for j, r in enumerate(out):
            xr = ref.x[j].cpu().numpy()
            d = float(np.linalg.norm(r.x - xr) / np.linalg.norm(xr))
            worst = max(worst, d)
            same = same and np.array_equal(r.x, xr)
            assert d <= 1e-12, (i, j, d)
            xt = xs[r.rid].cpu().numpy()
            err = max(err, float(np.linalg.norm(r.x - xt)
                                 / np.linalg.norm(xt)))
            assert np.isfinite(r.residual)
    assert err <= 1e-8, err
    say(f"phase 14 dense apc server k={K_MANY}, {ITERS} iterations: "
        f"{n_req} requests in 4 batches (the last 5 real + 3 padded); "
        f"store misses {st.misses} hits {st.hits}; executor builds "
        f"{srv.stats.executor_builds}, captures {ex.captures}; batches "
        f"2-4 quiet under tracecheck(steady_state=True); launches a batch "
        f"{[launched[i]['apc_gather'] for i in range(4)]} (apc_gather) "
        f"{[launched[i]['apc_scatter'] for i in range(4)]} (apc_scatter), "
        f"the first with the {head}-step eager head; served x vs "
        f"solve_many max rel {worst:.3e}, bit-identical {same}; vs x_true "
        f"max rel {err:.3e}")
    say(f"phase 14 dense apc server: ms a batch {', '.join(f'{v:.1f}' for v in ms)} "
        f"(the first with prepare, the pinv factors and the capture); "
        f"{n_req / sum(ms) * 1e3:.2f} RHS/s over the 4 batches, "
        f"{(n_req - K_MANY) / sum(ms[1:]) * 1e3:.2f} RHS/s over batches "
        f"2-4, padding excluded (host clock to synchronize()) [{card}]")
    say(f"phase 14 dense apc server memory: resident {base / 1e9:.3f} GB "
        f"before (A and b), +{(resident - base) / 1e9:.3f} GB after the "
        f"first batch (B {b_bytes / 1e9:.3f} GB, the Cholesky factors, the "
        f"graph's pool), peak +{(first_peak - base) / 1e9:.3f} GB in it "
        f"(prepare); batches 2-4 peak {steady_peak / 1e9:.3f} GB "
        f"(max_memory_allocated), +{(steady_peak - resident) / 1e6:.1f} MB "
        f"above the resident; the store's entry is the placement (A is the "
        f"system's own) [{card}]")

    # one batch split: the executor's cold run (init eagerly, outside the
    # graph, then the graph's steps) against its warm run (the graph's
    # steps alone), and init alone on the process's own library (what the
    # executor and eager solve_many run it on), on cuSOLVER and on MAGMA
    ex2 = executor.LocalExecutor(s, dprm, ITERS, use_kernel=True)
    Bb = ex2.place_B(groups(rhs, K_MANY)[0].reshape(K_MANY, dsys.m,
                                                    dsys.p), dsys.A_op)
    assert Bb.device == dsys.device
    warm = ex2.run(dsys.A_op, entry, Bb)[0]
    ex2.run(dsys.A_op, entry, Bb, warm)
    assert (ex2.builds, ex2.captures) == (2, 2)

    def init_on(lib):
        with linalg_library(lib):
            s.init(entry, Bb, dprm)
    split = medians_ms({
        "cold run": lambda: ex2.run(dsys.A_op, entry, Bb),
        "warm run": lambda: ex2.run(dsys.A_op, entry, Bb, warm),
        "init own": lambda: s.init(entry, Bb, dprm),
        "init cuSOLVER": lambda: init_on("cusolver"),
        "init MAGMA": lambda: init_on("magma")}, reps=3, batch=1)
    say(f"phase 14 one batch (dense apc k={K_MANY}, CUDA events, median of "
        f"3 in turns): cold run {split['cold run']:.3f} ms, warm run "
        f"({ITERS} steps, the graph alone) {split['warm run']:.3f} ms = "
        f"{split['warm run'] / ITERS:.4f} ms a step, so init (eager, "
        f"outside the graph) {split['cold run'] - split['warm run']:.3f} "
        f"ms; init alone: the process's own library "
        f"{split['init own']:.3f} ms, cuSOLVER {split['init cuSOLVER']:.3f}"
        f" ms, MAGMA {split['init MAGMA']:.3f} ms [{card}]")
    del ex2, Bb, warm

    # -- the same traffic through the async pipeline ---------------------
    asrv = solvers.AsyncLinsysServer(store, solver="apc", iters=ITERS,
                                     batch=K_MANY, use_kernel=True,
                                     pipeline_depth=2, **dprm)
    afp = asrv.register(dsys)
    for b in rhs:
        asrv.submit(afp, b)
    ops.reset_launch_counts()
    aout, a_ms = timed_ms(asrv.drain)
    a_launched = form_launches("f64")
    asrv.close()
    assert [r.rid for r in aout] == list(range(n_req))
    for r, e in zip(aout, served):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual, r.rid
    assert (asrv.stats.served, asrv.stats.shed) == (n_req, 0), asrv.stats
    assert a_launched == uses(USES["apc"], head + 4 * ITERS), a_launched
    rep = asrv.latency_report()
    say(f"phase 14 dense apc async (pipeline_depth 2): {n_req} requests "
        f"bit-equal to the sync server's in rid order, 0 shed; launches "
        f"{a_launched['apc_gather']} of each kernel; {a_ms:.1f} ms, "
        f"{n_req / a_ms * 1e3:.2f} RHS/s (its first batch captures); "
        f"latency p50/p95/p99 {rep['p50_ms']:.1f}/{rep['p95_ms']:.1f}/"
        f"{rep['p99_ms']:.1f} ms, mean {rep['mean_ms']:.1f}, max "
        f"{rep['max_ms']:.1f} (all submitted at t=0) [{card}]")
    osrv = solvers.AsyncLinsysServer(store, solver="apc", iters=ITERS,
                                     batch=K_MANY, use_kernel=True,
                                     admit_capacity=K_MANY, **dprm)
    ofp = osrv.register(dsys)
    tickets = [osrv.submit(ofp, b) for b in rhs[:20]]
    assert all(t.future.done() and isinstance(t.result(), Shed)
               for t in tickets[K_MANY:])
    assert (osrv.stats.admitted, osrv.stats.shed) == (K_MANY, 20 - K_MANY)
    oout = osrv.drain()
    osrv.close()
    assert [r.rid for r in oout] == list(range(20))
    assert all(isinstance(r, Shed) for r in oout[K_MANY:])
    for r, e in zip(oout[:K_MANY], served):
        assert not isinstance(r, Shed) and np.array_equal(r.x, e.x)
    say(f"phase 14 overload (admit_capacity {K_MANY}, 20 submitted before "
        f"the pipeline starts): admitted {osrv.stats.admitted}, each of "
        f"the {osrv.stats.shed} others an explicit Shed; the admitted "
        f"bit-equal to the sync server's")
    del srv, asrv, osrv, store, entry, ent, ex, dsys, xs
    gc.collect()
    torch.cuda.empty_cache()

    # -- the sparse path: mixed APC over two systems from a cold store
    # (sp and sp2, its rows doubled: its own fingerprint, factors and
    # placement, b doubled, the same x), sync (over a store with a disk
    # tier) and async (a store without one: its second miss runs on the
    # assembly thread while a pool thread captures the first system's
    # program); then a fresh store on the sync one's directory, as a
    # restarted process: two disk hits
    sprm, cprm = sp_pinned["apc"][0], sp_pinned["cimmino"][0]
    xs, srhs = consistent(sp, 2 * K_MANY, 15)
    sp2 = dataclasses.replace(sp, A_blocks=2 * sp.A_blocks,
                              b_blocks=2 * sp.b_blocks)
    pairs = ((sp, 1.0), (sp2, 2.0))
    sdir = ROOT / "build" / "phase14_factors"
    shutil.rmtree(sdir, ignore_errors=True)
    io_ms = {}

    def timing(store, name):
        """``store`` with its method ``name`` timed into ``io_ms``."""
        fn = getattr(store, name)

        def timed(*a, **k):
            out, t_ms = timed_ms(lambda: fn(*a, **k))
            io_ms.setdefault(name, []).append(t_ms)
            return out
        setattr(store, name, timed)
        return store

    mixed = {}
    for label, cls, mstore in (
            ("sync", solvers.LinsysServer, timing(solvers.FactorStore(
                directory=str(sdir)), "_disk_store")),
            ("async", solvers.AsyncLinsysServer, solvers.FactorStore()),
            ("restarted", solvers.LinsysServer, timing(solvers.FactorStore(
                directory=str(sdir)), "_disk_load"))):
        msrv = cls(mstore, solver="apc", iters=ITERS, batch=K_MANY,
                   use_kernel=True, precision="mixed", **sprm)
        mfps = [msrv.register(system) for system, _ in pairs]
        for b in srhs:                  # interleaved: rid 2i sp, 2i+1 sp2
            for mfp, (_, scale) in zip(mfps, pairs):
                msrv.submit(mfp, scale * b)
        ops.reset_launch_counts()
        out, t_ms = timed_ms(msrv.drain)
        got = form_launches("bf16_f64")
        if cls is solvers.AsyncLinsysServer:
            msrv.close()
        (mex,) = msrv._executors.values()
        entries = [mstore._mem[mfp] for mfp in mfps]
        for me in entries:
            assert me.A.vals.dtype == me.B.dtype == BF16, (label, me.B.dtype)
        assert mstore.stats.hits == 2, (label, mstore.stats)
        assert (mex.builds, mex.captures) == (2, 2), label
        assert got == uses(SPARSE_USES["apc"], 2 * head + 4 * ITERS), got
        mixed[label] = (sorted(out, key=lambda r: r.rid), t_ms, entries,
                        mstore.stats, mfps)
    (sout, s_ms, mes, st1, mfps), (aout, a_ms, _, _, _), \
        (rout, r_ms, _, st2, _) = mixed.values()
    assert (st1.misses, st1.disk_writes) == (2, 2), st1
    assert (st2.disk_hits, st2.misses) == (2, 0), st2
    assert [r.rid for r in aout] == [r.rid for r in sout] == list(
        range(4 * K_MANY))
    for r, e, d in zip(aout, sout, rout):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual
        assert np.array_equal(d.x, e.x) and d.residual == e.residual
    worst = 0.0
    for (system, scale), mfp, me in zip(pairs, mfps, mes):
        kfs = solvers.ExecutionPlan(kernel=True, precision="mixed",
                                    factors=me)
        mine = [r for r in sout if r.fp == mfp]
        for i, Bg in enumerate(groups(srhs, K_MANY)):
            ref = s.solve_many(system, scale * Bg, iters=ITERS, plan=kfs,
                               **sprm)
            for j, r in enumerate(mine[i * K_MANY:(i + 1) * K_MANY]):
                xr = ref.x[j].cpu().numpy()
                d = float(np.linalg.norm(r.x - xr) / np.linalg.norm(xr))
                worst = max(worst, d)
                assert d <= 1e-12, d
    size = sum(f.stat().st_size for f in sdir.rglob("*") if f.is_file())
    say(f"phase 14 sparse apc precision=mixed k={K_MANY}, two systems from "
        f"a cold store (sp, and sp2 its rows doubled), requests "
        f"interleaved: the store's entries bf16 (vals, Bvals) in the sync "
        f"and the async server; async bit-equal to sync for both; vs "
        f"solve_many max rel {worst:.3e}; {4 * K_MANY} requests in "
        f"{s_ms:.1f} ms sync (with the disk writes), {a_ms:.1f} ms async "
        f"(each with its two placements' captures) [{card}]")
    say(f"phase 14 disk tier (sparse apc mixed): the sync server missed "
        f"twice and wrote {size / 1e6:.1f} MB in "
        + " + ".join(f"{v:.1f}" for v in io_ms["_disk_store"])
        + f" ms; a fresh store on the directory: disk_hits "
        f"{st2.disk_hits} misses {st2.misses}, read in "
        + " + ".join(f"{v:.1f}" for v in io_ms["_disk_load"])
        + f" ms, the entries bf16, served x bit-equal to the first "
        f"server's; {4 * K_MANY} requests in {r_ms:.1f} ms [{card}]")
    shutil.rmtree(sdir, ignore_errors=True)
    del mixed, mes, sout, aout, rout, sp2, pairs
    gc.collect()
    torch.cuda.empty_cache()

    # -- a warm Cimmino server on perturbed right-hand sides ---------------
    wsrv = solvers.LinsysServer(solvers.FactorStore(), solver="cimmino",
                                iters=ITERS, batch=K_MANY, use_kernel=True,
                                warm_start=True, **cprm)
    wfp = wsrv.register(sp)
    noise = np.random.default_rng(16).standard_normal(srhs[:K_MANY].shape)
    events, res = [], []
    for i in range(4):
        for b in srhs[:K_MANY] + 1e-3 * i * noise:
            wsrv.submit(wfp, b)
        with tracecheck() as tc:
            out = wsrv.drain()
        events.append([e.fun for e in tc.traces()])
        assert [r.warm for r in out] == [i > 0] * K_MANY
        res.append(max(r.residual for r in out))
    (wex,) = wsrv._executors.values()
    assert events == [["build cimmino.cold", "capture cimmino.cold"],
                      ["build cimmino.warm", "capture cimmino.warm"], [],
                      []], events
    assert wsrv.stats.warm_batches == 3 and wex.captures == 2
    say(f"phase 14 sparse cimmino warm_start k={K_MANY}: 4 batches of "
        f"perturbed right-hand sides, warm_batches "
        f"{wsrv.stats.warm_batches}; the warm program captured once "
        f"(batches 3-4 quiet); worst final residual a batch "
        + ", ".join(f"{v:.3e}" for v in res))
    del wsrv, wex, xs

    # -- the CLIs ---------------------------------------------------------
    cdir = ROOT / "build" / "phase14_cli"
    shutil.rmtree(cdir, ignore_errors=True)
    args = ["--requests", "12", "--systems", "2", "--batch", "4",
            "--iters", "400", "--use-kernel", "--store-dir",
            str(cdir / "store")]
    texts = []
    for extra in ([], ["--async"]):
        rc, text = captured_stdout(lambda: serve_cli.main(args + extra),
                                   "phase 14 serve_linsys "
                                   + " ".join(extra or ["sync"]), card)
        assert rc == 0
        texts.append(text)
    assert "misses=2" in texts[0] and "disk_hits=2" in texts[1], texts
    assert "misses=0" in texts[1] and "0 shed" in texts[1]
    for i in range(2):
        rc, text = captured_stdout(lambda: solve_cli.main(
            CLI_ARGS + ["--ckpt-dir", str(cdir / "ckpt"), "--resume",
                        "--store-dir", str(cdir / "solve_store")]),
            f"phase 14 solve run {i + 1}", card)
        assert rc == 0
        assert (f"checkpointed at iter {200 * (i + 1)}" in text
                and ("resuming from checkpointed state at iter 200" in text)
                == (i == 1)), text
    shutil.rmtree(cdir, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    with env_var(ENGINE_ENV, "fused"):
        return phases()


def phases() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.core import blockops, partition, spectral
    from repro_torch.core.apc import APCState
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli
    from repro_torch.solvers import executor
    from repro_torch.solvers.projection import CimminoState, ProjFactors

    def form_launches(pair):
        """The launches since the last reset, by kernel; every one of them
        must have gone through the C entries of ``pair`` (a value of
        bp.PAIRS: "f64", "bf16_f64", "bf16_f32")."""
        got = ops.launch_counts(pair)
        assert got == ops.launch_counts(), (pair, ops.launch_counts())
        return got

    # 1. environment ------------------------------------------------------
    t0 = time.time()
    card = smi()
    name = torch.cuda.get_device_name(0)
    bw, peak = card_rates(name)
    say(f"phase 1 env: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    tb = time.time()
    lib = bp.build()["block_projection.cu"]
    say(f"phase 1 build: {time.time() - tb:.2f} s ({SOURCE}, sm_90a)")
    ptxas = ptxas_summary(lib.with_suffix(".log").read_text(),
                          bp.ring_smem_bytes)
    say("phase 1 ptxas: " + "; ".join(ptxas))
    for tag in ("f64", "bf16/f64"):      # every float64-compute ring
        rings = [x for x in ptxas if x.split()[1] == tag and "_ring " in x]
        assert all(" spill 0 B:" in x for x in rings), rings
        assert {x.split()[0] for x in rings} == {
            f"{kn}_ring" for kn in bp.RINGS}, rings
    # the all-bf16 form: the APC pair's two instances alone
    assert {x.split()[0] for x in ptxas if x.split()[1] == "bf16"} == {
        f"{kn}{inst}" for kn in bp.ALL_BF16 for inst in ("", "_ring")}, \
        ptxas

    # 2. kernel vs plain version ------------------------------------------
    max_abs = {}             # (kernel, form) -> max|Δ| at the main shapes

    def check(kname, got, want, pr, label, record):
        """got (in the compute dtype) against the plain version, at the
        compute dtype's tolerance; ``pr`` is the form (pair_label)."""
        assert got.dtype == want.dtype, (kname, label, pr, got.dtype)
        e, d = rel_err(got, want)
        assert e < TOL[got.dtype], (kname, label, pr, e)
        if record:
            max_abs[(kname, pr)] = max(max_abs.get((kname, pr), 0.0), d)
        return e

    def instances(kname, launch, want, matrix, copied, pr, label, record):
        """Both instances of a kernel of bp.RINGS, ``launch(instance,
        matrix)``: the row dot, and the ring where ``gather_instance``
        admits these operands; each against the plain version, and the
        two bit-identical — but for a bf16-stored scatter, whose row dot
        sums in the packed order: its ring is bit-identical to the ring on
        the matrix widened to the compute dtype.  Returns what held."""
        ring = bp.gather_instance(matrix, *copied) == "ring"
        outs = {inst: launch(inst, matrix) for inst in bp.INSTANCES
                if inst == "row_dot" or ring}
        torch.cuda.synchronize()
        for got in outs.values():
            check(kname, got.reshape(want.shape), want, pr, label, record)
        if not ring:
            return "row_dot"
        if kname in bp.SCATTERS and matrix.dtype == BF16:
            wide = launch("ring", matrix.to(copied[0].dtype))
            assert torch.equal(outs["ring"], wide), (kname, label)
            return "ring≡widened ring"
        assert torch.equal(outs["ring"], outs["row_dot"]), (kname, label)
        return "ring≡row_dot"

    def compare(A, B, X, Xb, V, gamma, label, record=False):
        """The four dense kernels against their plain versions; V stands in for
        both the APC scatter's U and the Cimmino scatter's V.  A and B in
        X's dtype or in bfloat16 (a mixed form)."""
        pr = pair_label(A, X)
        outs = {
            "apc_gather": (ops.proj_gather(A, X, Xb),
                           ops.apc_gather_ref(A, X, Xb)),
            "apc_scatter": (ops.proj_scatter(B, X, Xb, V, gamma),
                            ops.apc_scatter_ref(B, X, Xb, V, gamma)),
            "cimmino_gather": (ops.cimmino_gather(A, Xb),
                               ops.cimmino_gather_ref(A, Xb)),
            "cimmino_scatter": (ops.cimmino_scatter(B, V),
                                ops.cimmino_scatter_ref(B, V)),
        }
        torch.cuda.synchronize()
        errs = {kn: check(kn, got, want, pr, label, record)
                for kn, (got, want) in outs.items()}
        X3, Xb3 = (X, Xb) if X.dim() == 3 else (X[:, None], Xb[None])
        V3 = V if V.dim() == 3 else V[:, None]
        ran = {
            "apc_gather": instances(
                "apc_gather", lambda inst, M: bp.apc_gather(
                    M, X3, Xb3, _instance=inst), outs["apc_gather"][1], A,
                (X3, Xb3), pr, label, record),
            "apc_scatter": instances(
                "apc_scatter", lambda inst, M: bp.apc_scatter(
                    M, X3, Xb3, V3, gamma, _instance=inst),
                outs["apc_scatter"][1], B, (V3,), pr, label, record),
            "cimmino_gather": instances(
                "cimmino_gather", lambda inst, M: bp.cimmino_gather(
                    M, Xb3, _instance=inst), outs["cimmino_gather"][1], A,
                (Xb3,), pr, label, record),
            "cimmino_scatter": instances(
                "cimmino_scatter", lambda inst, M: bp.cimmino_scatter(
                    M, V3, _instance=inst), outs["cimmino_scatter"][1], B,
                (V3,), pr, label, record)}
        say(f"phase 2 {label} {pr}: " + " ".join(
            f"{kn} {e:.3e}" for kn, e in errs.items())
            + f" (tol {TOL[X.dtype]:.0e}); "
            + "; ".join(f"{kn} {how}" for kn, how in ran.items()))
        if X.dim() == 3:    # a batch row is bit-identical to a k=1 call
            i = X.shape[1] - 1
            rows = {
                "apc_gather": ops.proj_gather(A, X[:, i], Xb[i]),
                "apc_scatter": ops.proj_scatter(B, X[:, i], Xb[i], V[:, i],
                                                gamma),
                "cimmino_gather": ops.cimmino_gather(A, Xb[i]),
                "cimmino_scatter": ops.cimmino_scatter(B, V[:, i]),
            }
            for kn, row in rows.items():
                assert torch.equal(row, outs[kn][0][:, i]), (kn, label)

    def compare_sparse(vals, cols, Bv, X, Xb, V, gamma, label,
                       record=False):
        """The three sparse kernels against their plain versions, through
        the two sparse ops: U of each op is its gather's result, Y and R
        the two forms of ``sparse_scatter``; V is the Cimmino b.  vals and
        Bvals in X's dtype or in bfloat16 (a mixed form)."""
        pr = pair_label(vals, X)
        Y, U = ops.sparse_proj_update(vals, cols, Bv, X, Xb, gamma)
        R, Uc = ops.sparse_cimmino_update(vals, cols, Bv, V, Xb)
        Yr, Ur = ops.sparse_proj_update_ref(vals, cols, Bv, X, Xb, gamma)
        Rr, Ucr = ops.sparse_cimmino_update_ref(vals, cols, Bv, V, Xb)
        torch.cuda.synchronize()
        pairs = {"sparse_gather": [(U, Ur)],
                 "sparse_cimmino_gather": [(Uc, Ucr)],
                 "sparse_scatter": [(Y, Yr), (R, Rr)]}
        errs = {kn: max(check(kn, got, want, pr, label, record)
                        for got, want in outs) for kn, outs in pairs.items()}
        X3, Xb3 = (X, Xb) if X.dim() == 3 else (X[:, None], Xb[None])
        V3 = V if V.dim() == 3 else V[:, None]
        Ur3 = Ur if Ur.dim() == 3 else Ur[:, None]
        ran = {
            "sparse_gather": instances(
                "sparse_gather", lambda inst, M: bp.sparse_gather(
                    M, cols, X3, Xb3, _instance=inst), Ur, vals, (), pr,
                label, record),
            "sparse_cimmino_gather": instances(
                "sparse_cimmino_gather", lambda inst, M:
                bp.sparse_cimmino_gather(M, cols, Xb3, _instance=inst), Ucr,
                vals, (), pr, label, record)}
        # both forms of sparse_scatter on the plain gathers' U (APC, into
        # the AXPY pre-pass) and on V (Cimmino, into zeros)
        Y0 = X3 + gamma * (Xb3 - X3)
        for form, U_, out0, kw in (
                ("apc", Ur3, Y0, dict(X=X3, Xbar=Xb3, gamma=gamma)),
                ("cimmino", V3, torch.zeros_like(Y0), {})):
            want = ops.sparse_scatter_ref(Bv, cols, U_, out0, kw.get("X"),
                                          kw.get("Xbar"), gamma)
            ran[f"sparse_scatter {form}"] = instances(
                "sparse_scatter", lambda inst, M: bp.sparse_scatter(
                    M, cols, U_, out0.clone(), **kw, _instance=inst), want,
                Bv, (U_,), pr, label, record)
        say(f"phase 2 {label} {pr}: " + " ".join(
            f"{kn} {e:.3e}" for kn, e in errs.items())
            + f" (tol {TOL[X.dtype]:.0e}); "
            + "; ".join(f"{kn} {how}" for kn, how in ran.items()))
        if X.dim() == 3:    # a batch row is bit-identical to a k=1 call
            i = X.shape[1] - 1
            Y1, U1 = ops.sparse_proj_update(vals, cols, Bv, X[:, i], Xb[i],
                                            gamma)
            R1, Uc1 = ops.sparse_cimmino_update(vals, cols, Bv, V[:, i],
                                                Xb[i])
            for row, full in ((U1, U), (Y1, Y), (Uc1, Uc), (R1, R)):
                assert torch.equal(row, full[:, i]), label

    def sparse_inputs(vals, cols, n, k, dt, seed):
        """Seeded X (m,k,n), X̄ (k,n), V (m,k,p) as (m, k, .) views of
        (k, m, .) tensors (k = 1: without the k axis), vals/cols as given."""
        m, p, _ = vals.shape
        rng = np.random.default_rng(seed)
        g = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                       device="cuda").to(dt)
        X, Xb, V = g(k, m, n).transpose(0, 1), g(k, n), \
            g(k, m, p).transpose(0, 1)
        if k == 1:
            X, Xb, V = X[:, 0], Xb[0], V[:, 0]
        return X, Xb, V

    for spec in SPARSE_CORNERS:
        csys = linsys.banded_system(seed=0, device="cuda", **spec)
        cf = solvers.get("apc").kernel_factors(
            solvers.get("apc").prepare(csys.A_op, {}))
        for dt in TOL:
            for k in (1, 5, K_MANY, 11):
                X, Xb, V = sparse_inputs(cf.A.vals, csys.cols, csys.n, k, dt,
                                         seed=csys.n + k)
                for mdt in (dt, BF16):
                    compare_sparse(cf.A.vals.to(mdt), csys.cols,
                                   cf.B.to(mdt), X, Xb, V, 0.83,
                                   f"banded n={csys.n} m={csys.m} "
                                   f"p={csys.p} w={csys.cols.shape[1]} k={k}")
    # the sparse path's shapes: its band support, seeded values, and the
    # padded slots zeroed as as_sparse leaves them
    sn, sm, sbw = SPARSE["n"], SPARSE["m"], SPARSE["bandwidth"]
    sp_p = sn // sm
    band = np.zeros((sm, sn), bool)
    for i in range(sm):
        band[i, max(i * sp_p - sbw, 0):(i + 1) * sp_p + sbw] = True
    scols = torch.as_tensor(partition.support_cols(band), device="cuda")
    sw = scols.shape[1]
    rng = np.random.default_rng(11)
    svals = torch.as_tensor(rng.standard_normal((sm, sp_p, sw)),
                            device="cuda")
    sBv = torch.as_tensor(rng.standard_normal((sm, sw, sp_p)), device="cuda")
    for i in range(sm):          # every slot of a repeated (pad) column
        c = scols[i].cpu().numpy()
        _, inv, counts = np.unique(c, return_inverse=True,
                                   return_counts=True)
        pad = torch.as_tensor(np.flatnonzero(counts[inv] > 1),
                              device="cuda")
        svals[i][:, pad] = 0.0
        sBv[i][pad] = 0.0
    for k in (1, K_MANY):
        for dt in TOL:
            X, Xb, V = sparse_inputs(svals, scols, sn, k, dt, seed=k)
            for mdt in (dt, BF16):
                compare_sparse(svals.to(mdt), scols, sBv.to(mdt), X, Xb, V,
                               0.9, f"sparse path m={sm} p={sp_p} w={sw} "
                               f"n={sn} k={k}", record=True)
    del svals, sBv

    for dt in TOL:
        for (p, n) in RAGGED:
            for k in (1, 5, K_MANY, 11):
                A, B, X, Xb, V = inputs(3, p, n, k, dt, seed=p * n + k,
                                        transposed=k > 1)
                if k == 1:
                    X, Xb, V = X[:, 0], Xb[0], V[:, 0]
                for mdt in (dt, BF16):
                    compare(A.to(mdt), B.to(mdt), X, Xb, V, 0.83,
                            f"m=3 p={p} n={n} k={k}")

    t = time.time()
    sys_ = linsys.tall_gaussian(**FULL, seed=0, device="cuda")
    torch.cuda.synchronize()
    m, p, n = sys_.m, sys_.p, sys_.n
    say(f"data: tall_gaussian N={sys_.N} n={n} m={m} float64 in "
        f"{time.time() - t:.2f} s")
    solver = solvers.get("apc")
    factors = solver.kernel_factors(solver.prepare(sys_.A_op, {}))
    rng = np.random.default_rng(1)
    for k in (1, K_MANY):
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        V = torch.as_tensor(rng.standard_normal((k, m, p)), device="cuda")
        for dt in TOL:
            Xd, Xbd = X.to(dt).transpose(0, 1), Xb.to(dt)
            Vd = V.to(dt).transpose(0, 1)
            if k == 1:
                Xd, Xbd, Vd = Xd[:, 0], Xbd[0], Vd[:, 0]
            for mdt in (dt, BF16):
                A, B = factors.A.to(mdt), factors.B.to(mdt)
                compare(A, B, Xd, Xbd, Vd, 0.9, f"main path m={m} p={p} "
                        f"n={n} k={k}", record=True)
                del A, B

    # 3. the APC main path at full size -----------------------------------
    t = time.time()
    params, rho = solver.analyze(sys_)
    torch.cuda.synchronize()
    t_analyze = time.time() - t
    say(f"phase 3 analyze: gamma={params['gamma']:.6f} "
        f"eta={params['eta']:.6f} rho={rho:.6f} in {t_analyze:.2f} s")
    kplan = solvers.ExecutionPlan(kernel=True)
    ops.reset_launch_counts()
    t = time.time()
    res = solver.solve(sys_, iters=ITERS, plan=kplan, **params)
    torch.cuda.synchronize()
    t_solve = time.time() - t
    launches = form_launches("f64")
    err = float(torch.linalg.norm(res.x - sys_.x_true)
                / torch.linalg.norm(sys_.x_true))
    say(f"phase 3 solve kernel=True: {ITERS} iters in {t_solve:.2f} s "
        f"(prepare included), residual {float(res.residuals[-1]):.3e} "
        f"rel-error {err:.3e} iters_to_tol {res.iters_to_tol} "
        f"launches {launches}")
    assert err <= 1e-8, err
    assert launches == {kn: ITERS if kn in USES["apc"] else 0
                        for kn in bp.KERNELS}, launches
    res_u = solver.solve(sys_, iters=ITERS,
                         plan=solvers.ExecutionPlan(factors=factors),
                         **params)
    # the reference's kernel-vs-unfused contract
    # (tests/test_kernel_engine.py _close: rtol 1e-6, atol 1e-12)
    dres = float((res.residuals - res_u.residuals).abs().max())
    assert torch.allclose(res.residuals, res_u.residuals, rtol=1e-6,
                          atol=1e-12), dres
    assert torch.allclose(res.errors, res_u.errors, rtol=1e-6,
                          atol=1e-12)
    res2 = solver.solve(sys_, iters=ITERS, plan=kplan, **params)
    assert torch.equal(res2.residuals, res.residuals)
    assert torch.equal(res2.x, res.x)
    say(f"phase 3 checks: kernel vs unfused history max|Δ| {dres:.3e}; "
        f"repeat bit-identical")

    # 4. solve_many -------------------------------------------------------
    def consistent_rhs(system, seed):
        """K_MANY seeded solutions xs and their right-hand sides A xs."""
        xs = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (K_MANY, system.n)), device="cuda")
        return xs, (system.A_blocks.reshape(system.N, system.n) @ xs.T).T

    def many_vs_rows(s, prm, label, check_x, system, facs, xs, Bm, uses,
                     precision="default"):
        """solve_many with K_MANY rows through one launch of each kernel
        per step, each row against its single solve (``check_x`` also
        holds it to the row's x_true)."""
        kplan_p = solvers.ExecutionPlan(kernel=True, factors=facs,
                                        precision=precision)
        ops.reset_launch_counts()
        t = time.time()
        many = s.solve_many(system, Bm, iters=ITERS, plan=kplan_p, **prm)
        torch.cuda.synchronize()
        t_many = time.time() - t
        got = form_launches("f64" if precision == "default" else "bf16_f64")
        assert got == {kn: ITERS if kn in uses[s.name] else 0
                       for kn in bp.KERNELS}, got
        worst = 0.0
        for i in range(K_MANY):
            row = dataclasses.replace(
                system, b_blocks=Bm[i].reshape(system.m, system.p),
                x_true=xs[i], mode="square")
            one = s.solve(row, iters=ITERS, plan=kplan_p, **prm)
            d = float(torch.linalg.norm(many.x[i] - one.x)
                      / torch.linalg.norm(one.x))
            worst = max(worst, d)
            assert d <= 1e-12, (label, i, d)
            if check_x:
                assert float(torch.linalg.norm(many.x[i] - xs[i])
                             / torch.linalg.norm(xs[i])) <= 1e-8
        say(f"phase {label} solve_many k={K_MANY}"
            + ("" if precision == "default" else f" precision={precision}")
            + f": {ITERS} iters in "
            f"{t_many:.2f} s, launches {got}, max row vs single solve "
            f"{worst:.3e}")

    xs, Bm = consistent_rhs(sys_, 2)
    many_vs_rows(solver, params, "4", True, sys_, factors, xs, Bm, USES)

    # 5. Cimmino and consensus at full size --------------------------------
    t = time.time()
    mu = spectral.mu_extremes(spectral.x_matrix(sys_))
    lam = spectral.ata_extremes(sys_)
    torch.cuda.synchronize()
    t_spec = time.time() - t
    say(f"phase 5 spectrum: mu(X) [{mu[0]:.6e}, {mu[1]:.6e}] "
        f"lambda(AᵀA) [{lam[0]:.6e}, {lam[1]:.6e}] in {t_spec:.2f} s")
    # every solver's pinned parameters and theoretical rate from this one
    # analysis (the closed forms each solver's analyze() applies)
    apc_p = spectral.apc_optimal(*mu)
    nu_m, rho_cim = spectral.cimmino_optimal(*mu)
    a_dgd, rho_dgd = spectral.dgd_optimal(*lam)
    a_nag, b_nag, rho_nag = spectral.dnag_optimal(*lam)
    a_hbm, b_hbm, rho_hbm = spectral.dhbm_optimal(*lam)
    a_p, b_p, rho_p = spectral.dhbm_optimal(m * mu[0], m * mu[1])
    pinned = {
        "apc": ({"gamma": apc_p.gamma, "eta": apc_p.eta}, apc_p.rho),
        "cimmino": ({"nu": nu_m / m}, rho_cim),
        "consensus": ({"gamma": 1.0, "eta": 1.0},
                      spectral.consensus_rate(mu[0])),
        "dgd": ({"alpha": a_dgd}, rho_dgd),
        "dhbm": ({"alpha": a_hbm, "beta": b_hbm}, rho_hbm),
        "dnag": ({"alpha": a_nag, "beta": b_nag}, rho_nag),
        "madmm": ({"xi": 1.0}, None),
        "pdhbm": ({"alpha": a_p, "beta": b_p}, rho_p),
    }
    assert sorted(pinned) == solvers.available()
    for key in params:     # the same closed form as phase 3's analyze()
        assert math.isclose(pinned["apc"][0][key], params[key],
                            rel_tol=1e-9), key
    cim_launches = {}
    kernel_runs = {}
    for sname in ("cimmino", "consensus"):
        s = solvers.get(sname)
        prm = pinned[sname][0]
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(sys_, iters=ITERS, plan=kplan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = form_launches("f64")
        assert got == {kn: ITERS if kn in USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        if sname == "cimmino":
            cim_launches = got
        r_u = s.solve(sys_, iters=ITERS,
                      plan=solvers.ExecutionPlan(factors=factors), **prm)
        d = float((r.residuals - r_u.residuals).abs().max())
        assert torch.allclose(r.residuals, r_u.residuals, rtol=1e-6,
                              atol=1e-12), (sname, d)
        assert torch.allclose(r.errors, r_u.errors, rtol=1e-6, atol=1e-12)
        r2 = s.solve(sys_, iters=ITERS, plan=kplan, **prm)
        assert torch.equal(r2.residuals, r.residuals), sname
        assert torch.equal(r2.x, r.x), sname
        assert torch.isfinite(r.residuals).all()
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        kernel_runs[sname] = r
        say(f"phase 5 {sname} solve kernel=True: {ITERS} iters in "
            f"{t_solve:.2f} s (prepare included), residual "
            f"{float(r.residuals[-1]):.3e} iters_to_tol {r.iters_to_tol} "
            f"launches {got}; kernel vs unfused history max|Δ| {d:.3e}; "
            f"repeat bit-identical")
    many_vs_rows(solvers.get("cimmino"), pinned["cimmino"][0], "5", False,
                 sys_, factors, xs, Bm, USES)

    # 6. the paper's comparison -------------------------------------------
    kernel_runs["apc"] = res
    for sname, (prm, rho_th) in pinned.items():
        s = solvers.get(sname)
        t = time.time()
        if sname not in kernel_runs:
            kernel_runs[sname] = s.solve(sys_, iters=ITERS, **prm)
            torch.cuda.synchronize()
        r = kernel_runs[sname]
        assert torch.isfinite(r.residuals).all(), sname
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        dec = decay(r.residuals)
        say(f"phase 6 {s.paper_name or sname:>9} ({sname}, "
            f"{'kernel' if sname in USES else 'unfused'}): residual "
            f"{float(r.residuals[-1]):.3e} after {ITERS} iters, "
            f"iters_to_tol {r.iters_to_tol}, rho theory "
            f"{'n/a' if rho_th is None else f'{rho_th:.6f}'} measured "
            f"{'n/a' if dec is None else f'{dec:.6f}'}"
            + ("" if sname in USES else
               f", {time.time() - t:.2f} s with prepare"))
    f64_hist = {sname: kernel_runs[sname].residuals for sname in USES}
    del kernel_runs

    # 7. the CLI entry point ----------------------------------------------
    for method in ("apc", "cimmino"):
        ops.reset_launch_counts()
        rc = cli.main(CLI_ARGS + ["--method", method])
        assert rc == 0, rc
        got = ops.launch_counts()
        assert all((got[kn] > 0) == (kn in USES[method])
                   for kn in bp.KERNELS), (method, got)
        say(f"phase 7 cli {' '.join(CLI_ARGS)} --method {method}: rc {rc} "
            f"launches {got}")

    # 13. compile-once execution: the checks of each half -------------------
    def solve_k(s, system, k, plan, prm, Bk):
        """``solve`` (k = 1, the system's own b) or ``solve_many`` on the
        K_MANY right-hand sides ``Bk``."""
        if k == 1:
            return s.solve(system, iters=ITERS, plan=plan, **prm)
        return s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)

    def launched_instances(run):
        """(``run()``, the set of (kernel, instance) its launches took):
        a captured solve decides each instance once, at capture."""
        seen, launch = set(), bp._launch
        names = {v: inst for inst, v in bp.INSTANCES.items()}

        def spy(name, matrix, out, *args):
            seen.add((name, names[args[-2]]))     # the instance, then kc
            return launch(name, matrix, out, *args)
        bp._launch = spy
        try:
            return run(), seen
        finally:
            bp._launch = launch

    def captured_vs_eager(label, system, facs_of, prm_of, uses, Bk):
        """APC, consensus and Cimmino on the kernels, default and mixed,
        k = 1 and K_MANY: the captured solve's residual and error
        histories and x torch.equal to the eager loop's
        (``executor.disable_capture``), launches of each kernel 150 a
        solve (the replays counted), the instances it took those of the
        eager loop, and a bit-identical repeat."""
        for precision, facs in facs_of.items():
            pair = "f64" if precision == "default" else "bf16_f64"
            plan = solvers.ExecutionPlan(kernel=True, precision=precision,
                                         factors=facs)
            for sname in ("apc", "consensus", "cimmino"):
                s, prm = solvers.get(sname), prm_of[sname][0]
                for k in (1, K_MANY):
                    run = lambda: solve_k(s, system, k, plan, prm, Bk)  # noqa: E731,E501
                    ops.reset_launch_counts()
                    r, cap = launched_instances(run)
                    torch.cuda.synchronize()
                    got = form_launches(pair)
                    assert got == {kn: ITERS if kn in uses[sname] else 0
                                   for kn in bp.KERNELS}, (label, sname, got)
                    with executor.disable_capture():
                        e, eag = launched_instances(run)
                    r2 = run()
                    torch.cuda.synchronize()
                    assert cap == eag, (label, sname, precision, k, cap, eag)
                    for what in ("residuals", "errors", "x"):
                        a = getattr(r, what)
                        if a is None:
                            continue
                        assert torch.equal(a, getattr(e, what)), (
                            label, sname, precision, k, what)
                        assert torch.equal(a, getattr(r2, what)), (
                            label, sname, precision, k, what)
                    say(f"phase 13 {label} {sname} {precision} k={k}: "
                        f"captured ≡ eager loop (residuals, "
                        f"{'errors, ' if r.errors is not None else ''}x), "
                        f"launches {got}; instances captured "
                        f"{sorted(cap)} eager {sorted(eag)}; repeat "
                        f"bit-identical")

    def dgd_vs_eager(label, system, prm, Bk):
        """DGD, whose glue is cuBLAS: captured against the eager loop
        within 1e-12 relative, and whether it came out bit-identical."""
        s = solvers.get("dgd")
        for k in (1, K_MANY):
            run = lambda: solve_k(s, system, k, solvers.ExecutionPlan(),  # noqa: E731,E501
                                  prm, Bk)
            r = run()
            with executor.disable_capture():
                e = run()
            torch.cuda.synchronize()
            d = float(((r.residuals - e.residuals).abs()
                       / e.residuals.abs()).max())
            dx = float(torch.linalg.norm(r.x - e.x) / torch.linalg.norm(e.x))
            assert d <= 1e-12 and dx <= 1e-12, (label, k, d, dx)
            same = torch.equal(r.residuals, e.residuals) and torch.equal(
                r.x, e.x)
            say(f"phase 13 {label} dgd k={k} (cuBLAS glue): captured vs "
                f"eager loop max relative residual Δ {d:.3e}, x {dx:.3e} "
                f"(tol 1e-12); bit-identical {same}")

    def solve_times(label, system, facs_of, prm_of, snames, Bk, rounds=4):
        """Each solver's whole solve on the kernels per iteration, eager
        loop against captured, host clock around work ending in
        synchronize(), in turns, medians of ``rounds``."""
        plans = {precision: solvers.ExecutionPlan(
            kernel=True, precision=precision, factors=facs)
            for precision, facs in facs_of.items()}
        times = {(sname, precision, k, how): [] for sname in snames
                 for precision in plans for k in (1, K_MANY)
                 for how in ("eager", "captured")}
        for _ in range(rounds):
            for sname, precision, k, how in times:
                torch.cuda.synchronize()
                t = time.perf_counter()
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solve_k(solvers.get(sname), system, k, plans[precision],
                            prm_of[sname][0], Bk)
                torch.cuda.synchronize()
                times[(sname, precision, k, how)].append(
                    (time.perf_counter() - t) / ITERS * 1e3)
        med = {key: float(np.median(v)) for key, v in times.items()}
        for sname, precision, k, how in times:
            if how == "eager":
                e, c = med[(sname, precision, k, how)], med[
                    (sname, precision, k, "captured")]
                say(f"phase 13 {label} {sname} k={k} {precision}: whole "
                    f"solve {e:.4f} ms per iteration eager, {c:.4f} ms "
                    f"captured (ratio {e / c:.2f}; host clock to "
                    f"synchronize(), {ITERS} iterations, median of {rounds} "
                    f"in turns) [{card}]")
        return med

    def graphed(fn, n=10):
        """``n`` calls of ``fn`` captured into one CUDA graph (after an
        eager call): its replay."""
        fn()
        torch.cuda.synchronize()
        graph, _ = executor._capture(lambda: [fn() for _ in range(n)],
                                     "chip_smoke steps")
        return graph.replay

    def memory_of(run):
        """(bytes allocated at ``run()``'s peak above what was resident,
        for each CUDA graph captured in it the bytes it reserved for its
        private pool — device memory reserved across the capture, the
        cache emptied first — and the capture's host time in ms, from the
        device idle to the graph instantiated)."""
        pools, capture = [], executor._capture

        def spy(body, name):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_reserved()
            t = time.perf_counter()
            out = capture(body, name)
            pools.append((torch.cuda.memory_reserved() - before,
                          (time.perf_counter() - t) * 1e3))
            return out
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        executor._capture = spy
        try:
            run()
        finally:
            executor._capture = capture
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, pools

    def idle_share(label, run, unprofiled_ms):
        """The device's idle share over ``run()``: kernel time summed from
        the profiler's key_averages() over the wall window, and over the
        same run's unprofiled wall time ``unprofiled_ms``.  Without device
        time in the profile, the CUDA-event span instead, and the share
        not measured."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        if busy > 0:
            say(f"phase 13 {label}: device idle share {1 - busy / wall:.1%} "
                f"of the profiled window (kernels {busy:.3f} ms of "
                f"{wall:.3f} ms wall, profiler on), "
                f"{1 - busy / unprofiled_ms:.1%} of the unprofiled solve "
                f"({unprofiled_ms:.3f} ms wall) [{card}]")
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        say(f"phase 13 {label}: the profiler shows no device time; the "
            f"CUDA-event span of the solve is {start.elapsed_time(end):.3f} "
            f"ms; device idle share not measured [{card}]")

    # 12. precision="mixed", dense half -------------------------------------
    def upcast_twin(facs):
        """The bf16-rounded factors widened to float64: the default solve
        on them is what the mixed solve computes."""
        A = facs.A
        A = (A._replace(vals=A.vals.double()) if blockops.is_sparse(A)
             else A.double())
        return ProjFactors(A=A, chol=facs.chol, B=facs.B.double())

    # launches of each mixed run, by (system, solver): of the bf16/float64
    # form, and in float32_solves of the bf16/float32 and float32 forms
    mixed_launches, mixed32_launches, f32_launches = {}, {}, {}

    def mixed_solves(label, system, facs, prm_of, uses, f64_runs):
        """APC, consensus and Cimmino with precision="mixed" on ``facs``
        (the cast kernel factors): launches of the bf16/float64 form
        only, a bit-identical repeat, the upcast twin (float64 form only)
        within TWIN_TOL, the float64 history within the reference's bf16
        envelope."""
        twin = upcast_twin(facs)
        mplan = solvers.ExecutionPlan(kernel=True, precision="mixed",
                                      factors=facs)
        for sname in ("apc", "consensus", "cimmino"):
            s = solvers.get(sname)
            prm = prm_of[sname][0]
            ops.reset_launch_counts()
            t = time.time()
            r = s.solve(system, iters=ITERS, plan=mplan, **prm)
            torch.cuda.synchronize()
            t_solve = time.time() - t
            got = mixed_launches[(label, sname)] = form_launches("bf16_f64")
            want = {kn: ITERS if kn in uses[sname] else 0
                    for kn in bp.KERNELS}
            assert got == want, (label, sname, got)
            r2 = s.solve(system, iters=ITERS, plan=mplan, **prm)
            assert torch.equal(r2.residuals, r.residuals), (label, sname)
            assert torch.equal(r2.x, r.x), (label, sname)
            ops.reset_launch_counts()
            tw = s.solve(system, iters=ITERS, plan=solvers.ExecutionPlan(
                kernel=True, factors=twin), **prm)
            assert form_launches("f64") == want, (label, sname)
            d_tw = float((r.residuals - tw.residuals).abs().max())
            d_tx = float((r.x - tw.x).abs().max())
            assert d_tw <= TWIN_TOL and torch.allclose(
                r.errors, tw.errors, rtol=0, atol=TWIN_TOL), (sname, d_tw)
            assert torch.isfinite(r.residuals).all(), (label, sname)
            ref = f64_runs[sname]
            assert torch.allclose(r.residuals, ref, **MIXED_TOL), sname
            err = float(torch.linalg.norm(r.x - system.x_true)
                        / torch.linalg.norm(system.x_true))
            say(f"phase 12 {label} {sname} precision=mixed: {ITERS} iters "
                f"in {t_solve:.2f} s, residual {float(r.residuals[-1]):.3e} "
                f"(float64 run {float(ref[-1]):.3e}, max|Δ| "
                f"{float((r.residuals - ref).abs().max()):.3e}) rel-error "
                f"{err:.3e} launches {got}; upcast twin history max|Δ| "
                f"{d_tw:.3e}, x max|Δ| {d_tx:.3e}; repeat bit-identical")
        del twin
        gc.collect()
        torch.cuda.empty_cache()

    def as_float32(facs):
        """Kernel factors with every tensor cast to float32."""
        A = facs.A
        A = (A._replace(vals=A.vals.float()) if blockops.is_sparse(A)
             else A.float())
        return ProjFactors(A=A, chol=facs.chol.float(), B=facs.B.float())

    def float32_solves(label, system, facs, mfacs, prm_of, uses, f64_runs):
        """APC and Cimmino in float32: the default solve on ``facs`` cast
        to float32 (the kernels' float32/float32 form) and the
        precision="mixed" one on ``mfacs`` (bf16 A and B) with its
        Cholesky factor in float32 (the bfloat16/float32 form), on the
        system in float32.  Launches of the run's form only, a
        bit-identical repeat, the float64 history within F32_TOL (the
        float32 form) or the reference's bf16 envelope (the bf16/float32
        form)."""
        sys32 = dataclasses.replace(
            system, A_blocks=system.A_blocks.float(),
            b_blocks=system.b_blocks.float(), x_true=system.x_true.float())
        runs = (("float32", "f32", f32_launches, F32_TOL,
                 solvers.ExecutionPlan(kernel=True,
                                       factors=as_float32(facs))),
                ("precision=mixed float32", "bf16_f32", mixed32_launches,
                 MIXED_TOL, solvers.ExecutionPlan(
                     kernel=True, precision="mixed",
                     factors=mfacs._replace(chol=mfacs.chol.float()))))
        for what, pair, counts, tol, plan32 in runs:
            for sname in ("apc", "cimmino"):
                s = solvers.get(sname)
                prm = prm_of[sname][0]
                ops.reset_launch_counts()
                t = time.time()
                r = s.solve(sys32, iters=ITERS, plan=plan32, **prm)
                torch.cuda.synchronize()
                t_solve = time.time() - t
                got = counts[(label, sname)] = form_launches(pair)
                assert got == {kn: ITERS if kn in uses[sname] else 0
                               for kn in bp.KERNELS}, (label, sname, got)
                assert r.x.dtype == torch.float32, r.x.dtype
                r2 = s.solve(sys32, iters=ITERS, plan=plan32, **prm)
                assert torch.equal(r2.residuals, r.residuals), (label, sname)
                assert torch.equal(r2.x, r.x), (label, sname)
                assert torch.isfinite(r.residuals).all(), (label, sname)
                ref = f64_runs[sname]
                d = float((r.residuals.double() - ref).abs().max())
                assert torch.allclose(r.residuals.double(), ref,
                                      **tol), (label, sname, d)
                say(f"phase 12 {label} {sname} {what}: "
                    f"{ITERS} iters in {t_solve:.2f} s, residual "
                    f"{float(r.residuals[-1]):.3e} (float64 run "
                    f"{float(ref[-1]):.3e}, max|Δ| {d:.3e}) launches {got}; "
                    f"repeat bit-identical")
        del sys32, runs
        gc.collect()
        torch.cuda.empty_cache()

    mf = solver.cast_factors(factors, "mixed")
    say(f"phase 12 dense factors: A {tuple(mf.A.shape)} {mf.A.dtype}, B "
        f"{tuple(mf.B.shape)} {mf.B.dtype}, chol {mf.chol.dtype}")
    mixed_solves("dense", sys_, mf, pinned, USES, f64_hist)
    float32_solves("dense", sys_, factors, mf, pinned, USES, f64_hist)
    many_vs_rows(solver, params, "12", False, sys_, mf, xs, Bm, USES,
                 precision="mixed")

    # 8. times --------------------------------------------------------------
    rows = {}
    F64, F32 = "float64/float64", "float32/float32"

    def bound(work, dtype):
        """(bound ms, "bytes" or "operations") of ``work`` = (bytes,
        operations in ``dtype``)."""
        nbytes, nops = work
        t_bytes = nbytes / bw * 1e3
        t_ops = nops / peak[dtype] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def form_calls(kname, pr, calls):
        """The calls timed of ``kname`` in form ``pr``: the kernel
        (``ms``, the instance its launcher picks), its row-dot instance
        (``row_dot_ms``: a gather's in float64, a scatter's in every
        form), a scatter's ring instance (``ring_ms``,
        every form: gather_instance picks the row dot at k = 1 in float64
        and float32), its plain version (float64) and the library
        yardstick (where the matrix and the operands share a dtype)."""
        keep = {"ms"}
        if kname in bp.SCATTERS or (kname in bp.GATHERS and pr == F64):
            keep.add("row_dot_ms")
        if kname in bp.SCATTERS:
            keep.add("ring_ms")
        if pr == F64:
            keep.add("plain_ms")
        if not pr.startswith("bfloat16"):
            keep.add("library_ms")
        return {key: fn for key, fn in calls.items() if key in keep}

    def time_kernel(phase, kname, k, shape, forms, library, key=None):
        """CUDA-event medians, in turns, of a kernel in each of its forms
        (``forms``: form label -> (calls, work, compute dtype), the calls
        those of form_calls), each beside its bound from its work =
        (bytes, operations); kept in ``rows[(key or kname, k)]`` (the
        float64 form's numbers at the top, every form's under "forms") and
        printed, a line a form."""
        timed = {(pr, name): fn for pr, (calls, _, _) in forms.items()
                 for name, fn in form_calls(kname, pr, calls).items()}
        t = medians_ms(timed)
        r = {"forms": {}}
        for pr, (_, work, dt) in forms.items():
            f = {name: v for (fpr, name), v in t.items() if fpr == pr}
            f["bound_ms"], f["bound_by"] = bound(work, dt)
            r["forms"][pr] = f
            b = f["bound_ms"]
            say(f"phase {phase} {kname} k={k} {shape} {pr}: "
                f"{f['ms']:.4f} ms (bound {b:.4f} ms by {f['bound_by']}, "
                f"{b / f['ms']:.1%} of it)"
                + "".join(f", {inst} instance {f[key]:.4f} ms "
                          f"({b / f[key]:.1%})"
                          for inst, key in (("ring", "ring_ms"),
                                            ("row-dot", "row_dot_ms"))
                          if key in f)
                + (f", plain {f['plain_ms']:.4f} ms" if "plain_ms" in f
                   else "")
                + (f", {library} {f['library_ms']:.4f} ms"
                   if "library_ms" in f else ", library none"))
        r.update(r["forms"][F64])
        rows[(key or kname, k)] = r

    def pair_bounds(k, uses):
        """The bounds of an iteration's two kernels (rows keys) at k,
        summed: the bf16/float64 form's and the float64 form's, ms."""
        return (sum(rows[(kn, k)]["forms"]["bfloat16/float64"]["bound_ms"]
                    for kn in uses),
                sum(rows[(kn, k)]["bound_ms"] for kn in uses))

    b = sys_.b_blocks
    nu = pinned["cimmino"][0]["nu"]
    cim = solvers.get("cimmino")
    A, B = factors.A, factors.B
    A16, B16 = mf.A, mf.B
    A32, B32 = A.float(), B.float()
    say(f"phase 8 library yardstick of the bf16-stored forms: {NO_LIBRARY}")
    clocks("phase 8 start")
    for k in (1, K_MANY):
        rng = np.random.default_rng(3 + k)
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        X3 = X.transpose(0, 1)                       # (m, k, n) view
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        U = bp.apc_gather(A, X3, Xb)
        V = (b.expand(k, m, p).transpose(0, 1)
             - bp.cimmino_gather(A, Xb))             # (m, k, p)
        D = Xb - X3
        X3f, Xbf, Uf, Vf, Df = (t.float() for t in (X3, Xb, U, V, D))
        mkn, mkp, kn_, mpn = m * k * n, m * k * p, k * n, m * p * n

        def dense_work(ms, xs):
            """(bytes, ops) of each kernel with its matrix at ``ms`` bytes
            an element and the rest at ``xs``: each input read once, each
            output written once."""
            return {
                "apc_gather": (ms * mpn + xs * (mkn + kn_ + mkp),
                               2 * m * k * p * n + mkn),
                "apc_scatter": (ms * mpn + xs * (2 * mkn + kn_ + mkp),
                                2 * m * k * p * n + 4 * mkn),
                "cimmino_gather": (ms * mpn + xs * (kn_ + mkp),
                                   2 * m * k * p * n),
                "cimmino_scatter": (ms * mpn + xs * (mkp + mkn),
                                    2 * m * k * p * n),
            }

        def dense_calls(A_, B_, X_, Xb_, U_, V_, D_):
            """Every call form_calls may time, of each dense kernel, on one
            form's operands."""
            return {
                "apc_gather": dict(
                    ms=lambda: bp.apc_gather(A_, X_, Xb_),
                    row_dot_ms=lambda: bp.apc_gather(A_, X_, Xb_,
                                                     _instance="row_dot"),
                    plain_ms=lambda: ops.apc_gather_ref(A_, X_, Xb_),
                    library_ms=lambda: torch.matmul(D_, A_.transpose(1, 2))),
                "apc_scatter": dict(
                    ms=lambda: bp.apc_scatter(B_, X_, Xb_, U_, 0.9),
                    ring_ms=lambda: bp.apc_scatter(B_, X_, Xb_, U_, 0.9,
                                                   _instance="ring"),
                    row_dot_ms=lambda: bp.apc_scatter(
                        B_, X_, Xb_, U_, 0.9, _instance="row_dot"),
                    plain_ms=lambda: ops.apc_scatter_ref(B_, X_, Xb_, U_,
                                                         0.9),
                    library_ms=lambda: torch.matmul(U_, B_.transpose(1, 2))),
                "cimmino_gather": dict(
                    ms=lambda: bp.cimmino_gather(A_, Xb_),
                    row_dot_ms=lambda: bp.cimmino_gather(
                        A_, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.cimmino_gather_ref(A_, Xb_),
                    library_ms=lambda: torch.matmul(Xb_,
                                                    A_.transpose(1, 2))),
                "cimmino_scatter": dict(
                    ms=lambda: bp.cimmino_scatter(B_, V_),
                    ring_ms=lambda: bp.cimmino_scatter(
                        B_, V_, _instance="ring"),
                    row_dot_ms=lambda: bp.cimmino_scatter(
                        B_, V_, _instance="row_dot"),
                    plain_ms=lambda: ops.cimmino_scatter_ref(B_, V_),
                    library_ms=lambda: torch.matmul(V_, B_.transpose(1, 2))),
            }
        forms = {
            F64: (dense_calls(A, B, X3, Xb, U, V, D), dense_work(8, 8),
                  torch.float64),
            F32: (dense_calls(A32, B32, X3f, Xbf, Uf, Vf, Df),
                  dense_work(4, 4), torch.float32),
            "bfloat16/float64": (dense_calls(A16, B16, X3, Xb, U, V, D),
                                 dense_work(2, 8), torch.float64),
            "bfloat16/float32": (dense_calls(A16, B16, X3f, Xbf, Uf, Vf, Df),
                                 dense_work(2, 4), torch.float32)}
        # the ring is the instance the main path's shapes take, in every
        # form, but for the scatters' fixed rule: the row dot at k = 1
        # with a float64 or float32 matrix
        for A_, B_, X_, Xb_, U_, V_ in ((A, B, X3, Xb, U, V),
                                        (A32, B32, X3f, Xbf, Uf, Vf),
                                        (A16, B16, X3, Xb, U, V),
                                        (A16, B16, X3f, Xbf, Uf, Vf)):
            assert bp.gather_instance(A_, X_, Xb_) == "ring"
            assert bp.gather_instance(A_, Xb_) == "ring"
            for S_ in (U_, V_):
                assert bp.gather_instance(B_, S_, scatter=True) == (
                    "row_dot" if k == 1 and B_.dtype != BF16 else "ring")
        if k == 1:
            st = APCState(x=X[0], xbar=Xb[0], t=0)
            cst = CimminoState(xbar=Xb[0], t=0)
            bb = b
        else:
            st = APCState(x=X, xbar=Xb, t=0)
            cst = CimminoState(xbar=Xb, t=0)
            bb = b.expand(k, m, p)
        its = medians_ms({
            "APC": lambda: solver.step_many_residual(factors, bb, st,
                                                     params),
            "Cimmino": lambda: cim.step_many_residual(factors, bb, cst,
                                                      {"nu": nu}),
            "APC mixed": lambda: solver.step_many_residual(mf, bb, st,
                                                           params),
            "Cimmino mixed": lambda: cim.step_many_residual(mf, bb, cst,
                                                            {"nu": nu})})
        t_it, t_cit = its["APC"], its["Cimmino"]
        steps = {
            "APC": lambda: solver.step_many_residual(factors, bb, st, params),
            "Cimmino": lambda: cim.step_many_residual(factors, bb, cst,
                                                      {"nu": nu}),
            "APC mixed": lambda: solver.step_many_residual(mf, bb, st,
                                                           params),
            "Cimmino mixed": lambda: cim.step_many_residual(mf, bb, cst,
                                                            {"nu": nu})}
        g10 = medians_ms({meth: graphed(fn) for meth, fn in steps.items()},
                         batch=1)
        say(f"phase 8 iteration k={k} captured: " + "; ".join(
            f"{meth} {g10[meth] / 10:.4f} ms per step in a 10-step CUDA "
            f"graph (eager {its[meth]:.4f})" for meth in steps)
            + f" [{card}]")
        for kname in USES["apc"] + USES["cimmino"]:
            time_kernel(8, kname, k, f"m={m} p={p} n={n}",
                        {pr: (calls[kname], work[kname], dt)
                         for pr, (calls, work, dt) in forms.items()},
                        "torch.matmul")
        say(f"phase 8 iteration k={k}: APC {t_it:.4f} ms per step "
            f"(gather + scatter + master update + residual); Cimmino "
            f"{t_cit:.4f} ms per step (gather + v = b − u + scatter + "
            f"worker sum + master update + residual)")
        say(f"phase 8 iteration k={k} precision=mixed: " + "; ".join(
            f"{meth} {its[meth + ' mixed']:.4f} ms per step (float64 "
            f"{its[meth]:.4f}; bound of its two kernels bf16/float64 "
            "{:.4f} ms, float64 {:.4f} ms)".format(
                *pair_bounds(k, USES[meth.lower()]))
            for meth in ("APC", "Cimmino")))
        del U, V, D, X3f, Xbf, Uf, Vf, Df, forms
    clocks("phase 8 end")

    # 13. compile-once execution, dense half ---------------------------------
    dense_facs = {"default": factors, "mixed": mf}
    captured_vs_eager("dense", sys_, dense_facs, pinned, USES, Bm)
    dgd_vs_eager("dense", sys_, pinned["dgd"][0], Bm)
    aplan = solvers.ExecutionPlan(kernel=True, factors=factors)
    a_bytes = factors.A.numel() * factors.A.element_size()
    for k in (1, K_MANY):
        peaks, pools = {}, {}
        for how in ("eager", "captured"):
            def run():
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solve_k(solver, sys_, k, aplan, pinned["apc"][0], Bm)
            peaks[how], pools[how] = memory_of(run)
        say(f"phase 13 dense apc k={k} memory: peak above the resident "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB: eager "
            f"{peaks['eager'] / 1e9:.4f} GB, captured "
            f"{peaks['captured'] / 1e9:.4f} GB (max_memory_allocated); "
            f"the 16-step graph's pool {pools['captured'][0][0] / 1e6:.1f} "
            f"MB (memory_reserved across its capture; A and B "
            f"{a_bytes / 1e9:.3f} GB each), its capture "
            f"{pools['captured'][0][1]:.2f} ms on the host")
        # the pool holds a few steps' intermediates, never A or B
        assert pools["eager"] == [] and len(pools["captured"]) == 1
        assert pools["captured"][0][0] < a_bytes // 16, pools
    solve_times("dense", sys_, dense_facs, pinned, ("apc",), Bm)

    main_launches = {kn: (launches if kn in USES["apc"] else cim_launches)[kn]
                     for kn in USES["apc"] + USES["cimmino"]}
    del sys_, factors, mf, res, res_u, res2, A, B, A16, B16, A32, B32, X, \
        X3, Xb
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the sparse path at full size -------------------------------------
    t = time.time()
    sp = linsys.banded_system(**SPARSE, seed=0, device="cuda")
    torch.cuda.synchronize()
    m, p, n, w = sp.m, sp.p, sp.n, sp.cols.shape[1]
    say(f"phase 9 data: banded_system n={n} m={m} bandwidth="
        f"{SPARSE['bandwidth']} float64: p={p} w={w}, generator "
        f"{time.time() - t:.2f} s")
    t = time.time()
    X = spectral.x_matrix(sp)
    mu = spectral.mu_extremes(X)
    del X
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    apc_p = spectral.apc_optimal(*mu)
    nu_m, rho_cim = spectral.cimmino_optimal(*mu)
    sp_pinned = {
        "apc": ({"gamma": apc_p.gamma, "eta": apc_p.eta}, apc_p.rho),
        "consensus": ({"gamma": 1.0, "eta": 1.0},
                      spectral.consensus_rate(mu[0])),
        "cimmino": ({"nu": nu_m / m}, rho_cim)}
    say(f"phase 9 spectrum: mu(X) [{mu[0]:.6e}, {mu[1]:.6e}] in "
        f"{time.time() - t:.2f} s (x_matrix + eigvalsh of {n}^2); rho "
        + " ".join(f"{k} {v[1]:.6f}" for k, v in sp_pinned.items()))
    dn = sp.densified()
    t = time.time()
    fs = solver.kernel_factors(solver.prepare(sp.A_op, {}))
    fd = solver.kernel_factors(solver.prepare(dn.A_op, {}))
    torch.cuda.synchronize()
    say(f"phase 9 factors: sparse (vals, Bvals {tuple(fs.B.shape)}) and "
        f"densified (B {tuple(fd.B.shape)}) in {time.time() - t:.2f} s")
    sparse_launches, sp_hist = {}, {}
    for sname in ("apc", "consensus", "cimmino"):
        s = solvers.get(sname)
        prm = sp_pinned[sname][0]
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(sp, iters=ITERS, plan=kplan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = sparse_launches[sname] = form_launches("f64")
        assert got == {kn: ITERS if kn in SPARSE_USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        sp_hist[sname] = r.residuals
        r_u = s.solve(sp, iters=ITERS, plan=solvers.ExecutionPlan(factors=fs),
                      **prm)
        dres = float((r.residuals - r_u.residuals).abs().max())
        assert torch.allclose(r.residuals, r_u.residuals, rtol=1e-6,
                              atol=1e-12), (sname, dres)
        assert torch.allclose(r.errors, r_u.errors, rtol=1e-6, atol=1e-12)
        r_d = s.solve(dn, iters=ITERS, plan=solvers.ExecutionPlan(
            kernel=True, factors=fd), **prm)
        dx = float((r.x - r_d.x).abs().max())
        # tests/test_modes.py::test_sparse_matches_densified
        assert torch.allclose(r.x, r_d.x, rtol=1e-8, atol=1e-10), (sname, dx)
        r2 = s.solve(sp, iters=ITERS, plan=kplan, **prm)
        assert torch.equal(r2.residuals, r.residuals), sname
        assert torch.equal(r2.x, r.x), sname
        assert torch.isfinite(r.residuals).all()
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        err = float(torch.linalg.norm(r.x - sp.x_true)
                    / torch.linalg.norm(sp.x_true))
        say(f"phase 9 {sname} sparse solve kernel=True: {ITERS} iters in "
            f"{t_solve:.2f} s (prepare included), residual "
            f"{float(r.residuals[-1]):.3e} rel-error {err:.3e} iters_to_tol "
            f"{r.iters_to_tol} launches {got}; vs unfused sparse history "
            f"max|Δ| {dres:.3e}; vs densified dense-kernel x max|Δ| "
            f"{dx:.3e}; repeat bit-identical")
        if sname == "apc":
            assert err <= 1e-8, err
    xs, Bm = consistent_rhs(sp, 4)
    for sname in ("apc", "cimmino"):
        many_vs_rows(solvers.get(sname), sp_pinned[sname][0], "9", False, sp,
                     fs, xs, Bm, SPARSE_USES)
    del r, r_u, r_d, r2, xs, Bm

    # 12. precision="mixed", sparse half ------------------------------------
    msf = solver.cast_factors(fs, "mixed")
    say(f"phase 12 sparse factors: vals {tuple(msf.A.vals.shape)} "
        f"{msf.A.vals.dtype}, Bvals {tuple(msf.B.shape)} {msf.B.dtype}")
    mixed_solves("sparse", sp, msf, sp_pinned, SPARSE_USES, sp_hist)
    float32_solves("sparse", sp, fs, msf, sp_pinned, SPARSE_USES, sp_hist)

    # 10. least squares -----------------------------------------------------
    ls_cli = ["--problem", "tall_noisy", "--workers", "4", "--iters", "300"]
    for method, extra in (("cimmino", ["--use-kernel"]), ("dgd", [])):
        ops.reset_launch_counts()
        rc = cli.main(ls_cli + ["--method", method] + extra)
        assert rc == 0, rc
        got = ops.launch_counts()
        assert all((got[kn] > 0) == (kn in USES.get(method, ()) and bool(extra))
                   for kn in bp.KERNELS), (method, got)
        say(f"phase 10 cli {' '.join(ls_cli)} --method {method} "
            f"{' '.join(extra)}: rc {rc} launches {got}")
    t = time.time()
    ls = linsys.tall_gaussian(**LS_MID, device="cuda")
    say(f"phase 10 data: tall_gaussian {LS_MID} ({ls.mode}) in "
        f"{time.time() - t:.2f} s")
    for sname, plan in (("cimmino", kplan), ("dgd", solvers.ExecutionPlan())):
        s = solvers.get(sname)
        prm, rho = s.analyze(ls)
        t = time.time()
        ref = s.ls_reference(ls)
        t_ref = time.time() - t
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(ls, iters=LS_ITERS, plan=plan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = ops.launch_counts()
        assert got == {kn: LS_ITERS if plan.kernel and kn in USES[sname]
                       else 0 for kn in bp.KERNELS}, (sname, got)
        e = float(torch.linalg.norm(r.x - ref) / torch.linalg.norm(ref))
        assert e <= 1e-6, (sname, e)
        assert float(r.residuals[-1]) < 1e-8, sname
        say(f"phase 10 {sname} least squares "
            f"{'kernel' if plan.kernel else 'unfused'}: {LS_ITERS} iters in "
            f"{t_solve:.2f} s, optimality residual "
            f"{float(r.residuals[-1]):.3e}, iters_to_tol {r.iters_to_tol}, "
            f"rel-error to ls_reference {e:.3e} (ls_reference "
            f"{t_ref:.2f} s on the host), rho {rho:.6f}, launches {got}")
    del ls, r
    sp_cli = ["--problem", "banded", "--workers", "4", "--iters", "200",
              "--method", "apc", "--use-kernel"]
    ops.reset_launch_counts()
    rc = cli.main(sp_cli)
    assert rc == 0, rc
    got = ops.launch_counts()
    assert all((got[kn] > 0) == (kn in SPARSE_USES["apc"])
               for kn in bp.KERNELS), got
    say(f"phase 10 cli {' '.join(sp_cli)}: rc {rc} launches {got}")

    # 11. sparse times ------------------------------------------------------
    vals, cols, Bv = fs.A.vals, fs.A.cols, fs.B
    vals16, Bv16 = msf.A.vals, msf.B
    vals32, Bv32 = vals.float(), Bv.float()
    b = sp.b_blocks
    prm_apc, prm_cim = sp_pinned["apc"][0], sp_pinned["cimmino"][0]
    clocks("phase 11 start")
    for k in (1, K_MANY):
        rng = np.random.default_rng(7 + k)
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        X3 = X.transpose(0, 1)                       # (m, k, n) view
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        idx = cols[:, None, :].expand(m, k, w)
        U = bp.sparse_gather(vals, cols, X3, Xb)
        V = (b.expand(k, m, p).transpose(0, 1)
             - bp.sparse_cimmino_gather(vals, cols, Xb)).contiguous()
        Y0 = X3 + 0.9 * (Xb - X3)
        R0 = torch.zeros_like(Y0)
        # the library yardstick's operands, gathered beforehand
        Ds = torch.take_along_dim(Xb - X3, idx, dim=-1)
        Xs = torch.take_along_dim(Xb.expand(m, k, n), idx, dim=-1)
        mkw, mkp, mwp = m * k * w, m * k * p, m * w * p
        flops = 2 * m * k * p * w
        X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf, Xsf = (
            t.float() for t in (X3, Xb, U, V, Y0, R0, Ds, Xs))

        def sparse_work(ms, xs):
            """(bytes, ops) with vals/Bvals at ``ms`` bytes an element and
            X, X̄, U, Y at ``xs``: each input read once, each output once;
            the support columns of X/X̄ are what the gathers read, cols is
            int64."""
            return {
                "sparse_gather": (ms * mwp + 8 * m * w
                                  + xs * (2 * mkw + mkp), flops + mkw),
                "sparse_cimmino_gather": (ms * mwp + 8 * m * w
                                          + xs * (mkw + mkp), flops),
                "sparse_scatter": (ms * mwp + 8 * m * w
                                   + xs * (mkp + 3 * mkw), flops + 4 * mkw),
                "sparse_scatter cimmino": (ms * mwp + 8 * m * w
                                           + xs * (mkp + mkw), flops),
            }

        def sparse_calls(vals_, Bv_, X_, Xb_, U_, V_, Y0_, R0_, Ds_, Xs_):
            """Every call form_calls may time, of each sparse kernel (and
            the Cimmino form of sparse_scatter), on one form's
            operands."""
            return {
                "sparse_gather": dict(
                    ms=lambda: bp.sparse_gather(vals_, cols, X_, Xb_),
                    row_dot_ms=lambda: bp.sparse_gather(
                        vals_, cols, X_, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_gather_ref(vals_, cols, X_,
                                                           Xb_),
                    library_ms=lambda: torch.bmm(Ds_,
                                                 vals_.transpose(1, 2))),
                "sparse_cimmino_gather": dict(
                    ms=lambda: bp.sparse_cimmino_gather(vals_, cols, Xb_),
                    row_dot_ms=lambda: bp.sparse_cimmino_gather(
                        vals_, cols, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_cimmino_gather_ref(
                        vals_, cols, Xb_),
                    library_ms=lambda: torch.bmm(Xs_,
                                                 vals_.transpose(1, 2))),
                "sparse_scatter": dict(
                    ms=lambda: bp.sparse_scatter(Bv_, cols, U_, Y0_, X=X_,
                                                 Xbar=Xb_, gamma=0.9),
                    ring_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, U_, Y0_, X=X_, Xbar=Xb_, gamma=0.9,
                        _instance="ring"),
                    row_dot_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, U_, Y0_, X=X_, Xbar=Xb_, gamma=0.9,
                        _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_scatter_ref(
                        Bv_, cols, U_, Y0_, X_, Xb_, 0.9),
                    library_ms=lambda: torch.bmm(U_, Bv_.transpose(1, 2))),
                "sparse_scatter cimmino": dict(
                    ms=lambda: bp.sparse_scatter(Bv_, cols, V_, R0_),
                    ring_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, V_, R0_, _instance="ring"),
                    row_dot_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, V_, R0_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_scatter_ref(Bv_, cols, V_,
                                                            R0_),
                    library_ms=lambda: torch.bmm(V_, Bv_.transpose(1, 2))),
            }
        forms = {
            F64: (sparse_calls(vals, Bv, X3, Xb, U, V, Y0, R0, Ds, Xs),
                  sparse_work(8, 8), torch.float64),
            F32: (sparse_calls(vals32, Bv32, X3f, Xbf, Uf, Vf, Y0f, R0f,
                               Dsf, Xsf), sparse_work(4, 4), torch.float32),
            "bfloat16/float64": (
                sparse_calls(vals16, Bv16, X3, Xb, U, V, Y0, R0, Ds, Xs),
                sparse_work(2, 8), torch.float64),
            "bfloat16/float32": (
                sparse_calls(vals16, Bv16, X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf,
                             Xsf), sparse_work(2, 4), torch.float32)}
        # the ring is the instance the sparse path's shapes take, in every
        # form: both sparse gathers (vals alone decides) and both forms of
        # the scatter (Bvals and U), but for the scatter's fixed rule
        for vals_, Bv_, U_ in ((vals, Bv, U), (vals32, Bv32, Uf),
                               (vals16, Bv16, U), (vals16, Bv16, Uf)):
            assert bp.gather_instance(vals_) == "ring"
            for U2 in (U_, V.to(U_.dtype)):
                assert bp.gather_instance(Bv_, U2, scatter=True) == (
                    "row_dot" if k == 1 and Bv_.dtype != BF16 else "ring")
        for key in SPARSE_USES["apc"] + ("sparse_cimmino_gather",
                                         "sparse_scatter cimmino"):
            kname, _, form = key.partition(" ")
            time_kernel(11, kname, k, f"m={m} p={p} w={w} n={n}"
                        + (f" ({form.capitalize()} form)" if form else ""),
                        {pr: (calls[key], work[key], dt)
                         for pr, (calls, work, dt) in forms.items()},
                        "torch.bmm (operands gathered beforehand, "
                        "gather/scatter excluded)", key=key)
        if k == 1:      # what a single call between two events also times
            one = medians_ms({"ms": forms[F64][0]["sparse_gather"]["ms"]},
                             batch=1)["ms"]
            say(f"phase 11 timing method: sparse_gather k=1, one call "
                f"between two events {one:.4f} ms, in runs of 10 calls "
                f"{rows[('sparse_gather', 1)]['ms']:.4f} ms a call")
        if k == 1:
            st = APCState(x=X[0], xbar=Xb[0], t=0)
            cst = CimminoState(xbar=Xb[0], t=0)
            bb = b
        else:
            st = APCState(x=X, xbar=Xb, t=0)
            cst = CimminoState(xbar=Xb, t=0)
            bb = b.expand(k, m, p)
        its = medians_ms({
            (meth, label): (
                (lambda f=f: solver.step_many_residual(f, bb, st, prm_apc))
                if meth == "APC" else
                (lambda f=f: cim.step_many_residual(f, bb, cst, prm_cim)))
            for label, f in (("sparse", fs), ("densified", fd),
                             ("mixed", msf))
            for meth in ("APC", "Cimmino")})
        g10 = medians_ms({key: graphed(fn) for key, fn in (
            ((meth, label), (
                (lambda f=f: solver.step_many_residual(f, bb, st, prm_apc))
                if meth == "APC" else
                (lambda f=f: cim.step_many_residual(f, bb, cst, prm_cim))))
            for label, f in (("sparse", fs), ("mixed", msf))
            for meth in ("APC", "Cimmino"))}, batch=1)
        say(f"phase 11 iteration k={k} captured: " + "; ".join(
            f"{meth} {label} {ms / 10:.4f} ms per step in a 10-step CUDA "
            f"graph (eager {its[(meth, label)]:.4f})"
            for (meth, label), ms in g10.items()) + f" [{card}]")
        for meth, uses in (("APC", SPARSE_USES["apc"]),
                           ("Cimmino", ("sparse_cimmino_gather",
                                        "sparse_scatter cimmino"))):
            sp_ms, dn_ms = its[(meth, "sparse")], its[(meth, "densified")]
            say(f"phase 11 iteration k={k} {meth}: sparse {sp_ms:.4f} ms, "
                f"densified {dn_ms:.4f} ms per step (step_residual), "
                f"ratio {dn_ms / sp_ms:.2f} (n/w = {n / w:.2f})")
            b16, b64 = pair_bounds(k, uses)
            say(f"phase 11 iteration k={k} {meth} precision=mixed: sparse "
                f"{its[(meth, 'mixed')]:.4f} ms per step (float64 "
                f"{sp_ms:.4f}; bound of its two kernels bf16/float64 "
                f"{b16:.4f} ms, float64 {b64:.4f} ms)")
        del U, V, Y0, R0, Ds, Xs, X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf, Xsf, forms
    clocks("phase 11 end")

    # 13. compile-once execution, sparse half --------------------------------
    xs, Bm = consistent_rhs(sp, 4)
    sparse_facs = {"default": fs, "mixed": msf}
    captured_vs_eager("sparse", sp, sparse_facs, sp_pinned, SPARSE_USES, Bm)
    # a safe DGD step: λmax(AᵀA) <= ‖A‖_F²
    dgd_vs_eager("sparse", sp, {"alpha": 1.0 / float(
        torch.sum(fs.A.vals * fs.A.vals))}, Bm)
    med = solve_times("sparse", sp, sparse_facs, sp_pinned,
                      ("apc", "cimmino"), Bm)
    for precision, facs in sparse_facs.items():
        plan = solvers.ExecutionPlan(kernel=True, precision=precision,
                                     factors=facs)
        _, pools = memory_of(lambda: solver.solve(
            sp, iters=ITERS, plan=plan, **sp_pinned["apc"][0]))
        say(f"phase 13 sparse apc k=1 {precision}: the 16-step graph's "
            f"capture {pools[0][1]:.2f} ms on the host, its pool "
            f"{pools[0][0] / 1e6:.1f} MB [{card}]")
        for how in ("eager", "captured"):
            def run():
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solver.solve(sp, iters=ITERS, plan=plan,
                                 **sp_pinned["apc"][0])
            idle_share(f"sparse apc k=1 {precision} {how}", run,
                       med[("apc", precision, 1, how)] * ITERS)
    # the serving executor: 3 batches of new right-hand sides, one system
    s, prm = solvers.get("apc"), sp_pinned["apc"][0]
    ex = executor.LocalExecutor(s, prm, ITERS, use_kernel=True)
    key = executor.executor_key(s, sp, prm, kplan, K_MANY, ITERS)
    batches = [consistent_rhs(sp, seed)[1].reshape(K_MANY, m, p)
               for seed in (5, 6, 7)]
    outs = []
    with tracecheck() as tc:
        _, ex_pools = memory_of(
            lambda: outs.append(ex.run(sp.A_op, fs, batches[0])))
    x1 = outs[0][1].clone()
    with tracecheck(steady_state=True):
        outs += [ex.run(sp.A_op, fs, Bb) for Bb in batches[1:]]
    torch.cuda.synchronize()
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1), (
        ex.builds, ex.captures)
    assert torch.equal(outs[0][1], x1)
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"], tc.summary()
    worst, same = 0.0, True
    for Bb, (_, X, res) in zip(batches, outs):
        ref = s.solve_many(sp, Bb.reshape(K_MANY, -1), iters=ITERS,
                           plan=solvers.ExecutionPlan(kernel=True,
                                                      factors=fs), **prm)
        d = float(torch.linalg.norm(X - ref.x) / torch.linalg.norm(ref.x))
        worst = max(worst, d)
        same = same and torch.equal(X, ref.x) and torch.equal(
            res, ref.residuals)
        assert d <= 1e-12 and torch.allclose(res, ref.residuals, rtol=1e-9,
                                             atol=1e-14), d
    say(f"phase 13 executor apc k={K_MANY} sparse, 3 batches: builds "
        f"{ex.builds} captures {ex.captures} cache {ex.cache_size()}; "
        f"runs 2-3 quiet under tracecheck(steady_state=True); first x "
        f"intact after the third; vs solve_many x max rel {worst:.3e}, "
        f"bit-identical {same}; its graph's pool "
        f"{ex_pools[0][0] / 1e6:.1f} MB, its capture {ex_pools[0][1]:.2f} "
        f"ms; key {key}; first run: "
        + "; ".join(str(e) for e in tc.traces()))
    # serving's steady state: a replay of the executor's program against
    # solve_many of the same batch, eager and captured, in turns
    kfs = solvers.ExecutionPlan(kernel=True, factors=fs)
    served = {"executor replay": lambda: ex.run(sp.A_op, fs, batches[1]),
              "solve_many eager": lambda: s.solve_many(
                  sp, batches[1].reshape(K_MANY, -1), iters=ITERS,
                  plan=kfs, **prm),
              "solve_many captured": lambda: s.solve_many(
                  sp, batches[1].reshape(K_MANY, -1), iters=ITERS,
                  plan=kfs, **prm)}
    times = {how: [] for how in served}
    for _ in range(4):
        for how, run in served.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (executor.disable_capture() if how.endswith("eager")
                  else contextlib.nullcontext()):
                run()
            torch.cuda.synchronize()
            times[how].append((time.perf_counter() - t) / ITERS * 1e3)
    assert (ex.builds, ex.captures) == (1, 1)
    say(f"phase 13 executor apc k={K_MANY} sparse, a batch of {ITERS} "
        "iterations: " + "; ".join(
            f"{how} {float(np.median(v)):.4f} ms per iteration"
            for how, v in times.items())
        + f" (host clock to synchronize(), median of 4 in turns) [{card}]")
    del ex, outs, batches, xs, Bm

    # 14. serving: the factor store, the servers, the CLI -----------------
    serving_phase(card, form_launches, pinned["apc"][0], sp, sp_pinned)

    # 15. the kernel ops layer: all-bf16, engine verdicts, k-chunks --------
    t15 = time.time()
    clocks("phase 15 start")
    dm, dp, dn = FULL["m"], FULL["N"] // FULL["m"], FULL["n"]
    shape = f"m={dm} p={dp} n={dn}"
    # (a) the all-bf16 apc_gather/apc_scatter at the dense main path's
    # shapes; the scatter takes the plain gather's U (bf16, as between the
    # two passes)
    bf_launches = {}
    A16 = randn(151, dm, dp, dn, dtype=BF16)
    B16 = randn(152, dm, dn, dp, dtype=BF16)
    for k in (1, K_MANY):
        X16 = randn(153 + k, k, dm, dn, dtype=BF16).transpose(0, 1)
        Xb16 = randn(154 + k, k, dn, dtype=BF16)
        U16 = ops.apc_gather_ref(A16, X16, Xb16)
        Y16 = ops.apc_scatter_ref(B16, X16, Xb16, U16, 0.9)
        torch.cuda.synchronize()
        mkn, mkp, kn_, mpn = dm * k * dn, dm * k * dp, k * dn, dm * dp * dn
        specs = {
            "apc_gather": dict(
                launch=lambda inst=None: bp.apc_gather(A16, X16, Xb16,
                                                      _instance=inst),
                want=U16, fits=bp.gather_instance(A16, X16, Xb16),
                default=bp.gather_instance(A16, X16, Xb16),
                plain=lambda: ops.apc_gather_ref(A16, X16, Xb16),
                library=lambda D=Xb16 - X16: torch.matmul(
                    D, A16.transpose(1, 2)),
                work=(2 * (mpn + mkn + kn_ + mkp), 2 * dm * k * dp * dn
                      + mkn)),
            "apc_scatter": dict(
                launch=lambda inst=None: bp.apc_scatter(
                    B16, X16, Xb16, U16, 0.9, _instance=inst),
                want=Y16, fits=bp.gather_instance(B16, U16),
                default=bp.gather_instance(B16, U16, scatter=True),
                plain=lambda: ops.apc_scatter_ref(B16, X16, Xb16, U16, 0.9),
                library=lambda: torch.matmul(U16, B16.transpose(1, 2)),
                work=(2 * (mpn + 2 * mkn + kn_ + mkp), 2 * dm * k * dp * dn
                      + 4 * mkn)),
        }
        timed = {}
        for kname, sp_ in specs.items():
            insts = [i for i in bp.INSTANCES
                     if i == "row_dot" or sp_["fits"] == "ring"]
            outs = {i: sp_["launch"](i) for i in insts}
            torch.cuda.synchronize()
            errs = {i: rel_err(o, sp_["want"]) for i, o in outs.items()}
            for i, (e, _) in errs.items():
                assert outs[i].dtype == BF16 and e < BF16_TOL, (kname, k, i,
                                                                e)
            max_abs[(kname, BF)] = max(
                [max_abs.get((kname, BF), 0.0)]
                + [d for _, d in errs.values()])
            same = (torch.equal(outs["ring"], outs["row_dot"])
                    if "ring" in outs else None)
            say(f"phase 15 {kname} k={k} {shape} {BF}: " + "; ".join(
                f"{i} {e:.3e}" for i, (e, _) in errs.items())
                + f" (tol {BF16_TOL:.0e}); ring≡row_dot {same}; the "
                f"launcher takes the {sp_['default']}")
            timed.update({(kname, "ms"): sp_["launch"],
                          (kname, "row_dot_ms"): lambda f=sp_["launch"]: f(
                              "row_dot"),
                          (kname, "plain_ms"): sp_["plain"],
                          (kname, "library_ms"): sp_["library"]})
            if kname in bp.SCATTERS and sp_["fits"] == "ring":
                timed[(kname, "ring_ms")] = lambda f=sp_["launch"]: f("ring")
        t = medians_ms(timed)
        for kname, sp_ in specs.items():
            f = {key: v for (kn, key), v in t.items() if kn == kname}
            f["bound_ms"], f["bound_by"] = bound(sp_["work"], BF16)
            rows[(kname, k)]["forms"][BF] = f
            b_ = f["bound_ms"]
            say(f"phase 15 {kname} k={k} {shape} {BF}: {f['ms']:.4f} ms "
                f"(bound {b_:.4f} ms by {f['bound_by']}, "
                f"{b_ / f['ms']:.1%} of it), row-dot instance "
                f"{f['row_dot_ms']:.4f} ms"
                + (f", ring instance {f['ring_ms']:.4f} ms"
                   if "ring_ms" in f else "")
                + f", plain {f['plain_ms']:.4f} ms, torch.matmul bf16 "
                f"{f['library_ms']:.4f} ms [{card}]")
        # ops.block_projection all-bf16 end to end (k = 1: no batch axis)
        Xe, Xbe = (X16[:, 0], Xb16[0]) if k == 1 else (X16, Xb16)
        ops.reset_launch_counts()
        Y = ops.block_projection(A16, B16, Xe, Xbe, 0.9)
        got = bf_launches[k] = form_launches("bf16_bf16")
        assert got == {kn: 1 if kn in USES["apc"] else 0
                       for kn in bp.KERNELS}, got
        e, _ = rel_err(Y, ops.block_projection_ref(A16, B16, Xe, Xbe, 0.9))
        assert Y.dtype == BF16 and Y.shape == Xe.shape and e < BF16_TOL, e
        say(f"phase 15 ops.block_projection k={k} {shape} {BF}: vs plain "
            f"{e:.3e} (tol {BF16_TOL:.0e}), launches {got}")
        del X16, Xb16, U16, Y16, Y, timed, specs
    del A16, B16
    # (b) the measured engine verdicts, no pin, then solves under them
    t = time.time()
    dsys = linsys.tall_gaussian(**FULL, seed=0, device="cuda")
    dfac = solver.kernel_factors(solver.prepare(dsys.A_op, {}))
    torch.cuda.synchronize()
    say(f"phase 15 data: the dense main path regenerated, its kernel "
        f"factors, in {time.time() - t:.2f} s")
    sw = fs.A.vals.shape[2]
    where = {"apc": (dfac.A, dp, dn, None), "cimmino": (dfac.A, dp, dn, None),
             "apc_sparse": (fs.A.vals, sp.p, sp.n, sw),
             "cimmino_sparse": (fs.A.vals, sp.p, sp.n, sw)}
    verdicts = {}
    with env_var(ENGINE_ENV, None):
        for family, (M, fp_, fn_, fw) in where.items():
            for k in (1, K_MANY):
                t = time.time()
                v = verdicts[(family, k)] = ops.use_fused(
                    family, fp_, fn_, k, M.dtype, w=fw, device=M.device,
                    compute_dtype=torch.float64)
                times = ops.engine_times.get(ops.engine_key(
                    family, fp_, fn_, k, M.dtype, w=fw))
                say(f"phase 15 engine {family} k={k} p={fp_} n={fn_}"
                    + ("" if fw is None else f" w={fw}") + " float64: "
                    + ("not measured (the heuristic)" if times is None else
                       f"fused {times[0] * 1e3:.4f} ms, unfused "
                       f"{times[1] * 1e3:.4f} ms (best of 5, "
                       f"{ops._MEAS_WORKERS} workers; fused wins within "
                       f"{ops._ENGINE_MARGIN})")
                    + f" -> {'fused' if v else 'unfused'}, resolved in "
                    f"{time.time() - t:.2f} s [{card}]")
    for label, system, facs, prm_of, uses, fam in (
            ("dense", dsys, dfac, pinned, USES, ""),
            ("sparse", sp, fs, sp_pinned, SPARSE_USES, "_sparse")):
        _, Bk = consistent_rhs(system, 9)
        plan = solvers.ExecutionPlan(kernel=True, factors=facs)
        for sname in ("apc", "cimmino"):
            s, prm = solvers.get(sname), prm_of[sname][0]
            fused = verdicts[(sname + fam, K_MANY)]
            with env_var(ENGINE_ENV, None):
                ops.reset_launch_counts()
                r = s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)
                torch.cuda.synchronize()
                got = ops.launch_counts()
            assert got == {kn: ITERS if fused and kn in uses[sname] else 0
                           for kn in bp.KERNELS}, (label, sname, got)
            r_f = s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)
            d = float(((r.residuals - r_f.residuals).abs()
                       / r_f.residuals.abs()).max())
            assert torch.allclose(r.residuals, r_f.residuals, rtol=1e-6,
                                  atol=1e-12), (label, sname, d)
            say(f"phase 15 {label} {sname} solve_many k={K_MANY} no pin: "
                f"verdict {'fused' if fused else 'unfused'}, launches "
                f"{got}; history vs the pinned-fused one max rel "
                f"{d:.3e}")
    # (c) each k-chunk pin on a K_MANY gather and scatter of the main path
    X8 = randn(160, K_MANY, dm, dn).transpose(0, 1)
    Xb8 = randn(161, K_MANY, dn)
    U8 = ops.apc_gather_ref(dfac.A, X8, Xb8)
    Y8 = ops.apc_scatter_ref(dfac.B, X8, Xb8, U8, 0.9)
    outs = {}
    for kc in bp.KC_VALUES:
        with env_var(BK_ENV, str(kc)):
            outs[kc] = (ops.proj_gather(dfac.A, X8, Xb8),
                        ops.proj_scatter(dfac.B, X8, Xb8, U8, 0.9))
        torch.cuda.synchronize()
        for got, want in zip(outs[kc], (U8, Y8)):
            assert rel_err(got, want)[0] < TOL[torch.float64], kc
    with env_var(BK_ENV, "16"):     # divides k = 16, not instantiated
        try:
            ops.proj_gather(randn(162, 2, 8, 128), randn(163, 2, 16, 128),
                            randn(164, 16, 128))
            raise AssertionError("REPRO_KERNEL_BK=16 launched")
        except ValueError as e:
            refused = str(e)
    same = all(torch.equal(outs[kc][i], outs[1][i]) for kc in bp.KC_VALUES
               for i in (0, 1))
    kc_ms = medians_ms({(kn, kc): (
        (lambda kc=kc: bp.apc_gather(dfac.A, X8, Xb8, kc=kc))
        if kn == "apc_gather" else
        (lambda kc=kc: bp.apc_scatter(dfac.B, X8, Xb8, U8, 0.9, kc=kc)))
        for kn in USES["apc"] for kc in bp.KC_VALUES})
    measured = {key: v for key, v in ops.tile_cache().items()
                if key[:3] == (K_MANY, dp, dn)}
    say(f"phase 15 KC pins k={K_MANY} {shape} float64: each against the "
        f"plain version within {TOL[torch.float64]:.0e}; outputs bit-equal "
        f"across the pins {same}; " + "; ".join(
            f"KC={kc} apc_gather {kc_ms[('apc_gather', kc)]:.4f} ms "
            f"apc_scatter {kc_ms[('apc_scatter', kc)]:.4f} ms"
            for kc in bp.KC_VALUES)
        + f" (in turns); the tile cache at these shapes {measured}; a pin "
        f"of 16 refused: {refused} [{card}]")
    del dsys, dfac, X8, Xb8, U8, Y8, outs
    gc.collect()
    torch.cuda.empty_cache()
    clocks("phase 15 end")
    say(f"phase 15: {time.time() - t15:.1f} s")

    main_launches.update(
        {kn: sparse_launches["apc" if kn in SPARSE_USES["apc"]
                             else "cimmino"][kn]
         for kn in SPARSE_USES["apc"] + SPARSE_USES["cimmino"]})
    # each form's launches, each from its own runs (counts reset just
    # before each and read by form just after): dense APC and Cimmino,
    # sparse APC and Cimmino
    def by_kernel(runs):
        return {kn: runs[(label, sname)][kn]
                for label, uses in (("dense", USES), ("sparse", SPARSE_USES))
                for sname in ("apc", "cimmino") for kn in uses[sname]}

    form_main = {F64: main_launches, F32: by_kernel(f32_launches),
                 "bfloat16/float64": by_kernel(mixed_launches),
                 "bfloat16/float32": by_kernel(mixed32_launches),
                 BF: bf_launches[1]}
    kernels = []
    for kname in bp.KERNELS:
        r = rows[(kname, 1)]
        forms = []
        for pr, f in r["forms"].items():
            forms.append({
                "pair": pr, "k": 1, "ms": f["ms"],
                "row_dot_ms": f.get("row_dot_ms"),
                "ring_ms": f.get("ring_ms"), "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"],
                "launches": form_main[pr][kname],
                "max_abs_err": max_abs[(kname, pr)],
                "library_ms": f.get("library_ms"),
                "library": None if "library_ms" in f else NO_LIBRARY})
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": main_launches[kname],
            "max_abs_err": max_abs[(kname, "float64/float64")],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "forms": forms})
    say(json.dumps({"kernels": kernels}))
    say(f"total {time.time() - t0:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
