#!/usr/bin/env python3
"""Probe of the tensor-core form of ``apc_gather`` and ``apc_scatter``
(bf16 matrix, float64 operands) on one NVIDIA GPU.

    python3 scripts/probe_mma_widen.py [--baseline DIR] [--diagnostics]
        [--reps 15]

Builds the bf16/float64 library of ``kernels/csrc/block_projection.cu``
as it is (``mma``) and as VARIANTS write it from the source (``int_widen``:
each bf16 widened to float64 by integer operations on its bits and one
exact multiply by 2^896, in place of F2F.F64.F32), with ``--baseline``
the same library from another checkout's source, and with
``--diagnostics`` the DIAGNOSTICS variants (the matrix copies without
the 256-byte L2 fetch; and, their results not checked, the consumers
skipping every stage, the mma replaced by an integer fold, the widening
by a bit copy); every variant's source under ``build/probe_mma/``, all
``nvcc`` processes at once.  Then, for each library:

* both instances (ring and row dot) of the two kernels against their
  plain versions (``ops.apc_gather_ref``, ``ops.apc_scatter_ref``) within
  1e-12 of max|plain| + 1, at ragged shapes and at the main path's (m 16,
  p 2048, n 16384), k = 1, 3, 8, 11; the two instances bit-identical and
  a batch row bit-identical to a k = 1 call (the baseline: the plain
  tolerance alone);
* CUDA-event medians of each kernel at the main path's shapes, k = 1 and
  8, the libraries timed in turns (first to last, then last to first),
  each beside its bytes bound at 3.35 TB/s.

Prints each library's ptxas lines for the two kernels, the card's
``nvidia-smi`` line, and exits non-zero on any failure or without a card.
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

PAIR = (torch.bfloat16, torch.float64)
SUFFIX = bp.PAIRS[PAIR]
PAIR_INDEX = list(bp.PAIRS).index(PAIR)
OUT = ROOT / "build" / "probe_mma"
HBM = 3.35e12
TOL = 1e-12
MAIN = (16, 2048, 16384)
SHAPES = ((3, 7, 130), (3, 64, 136), (2, 100, 1000), (3, 130, 64),
          (2, 1, 8), MAIN)
# name -> the (text, replacement) pairs that write the variant from the
# source: VARIANTS always, DIAGNOSTICS with --diagnostics; a name that
# starts with "diag" computes something else and is timed only
WIDEN = ("  lo = static_cast<double>(__uint_as_float(w << 16));\n"
         "  hi = static_cast<double>(__uint_as_float(w & 0xffff0000u));")
VARIANTS = {
    "int_widen": [(WIDEN, "\n".join(
        f"  {name} = __hiloint2double(static_cast<int>(static_cast<uint32_t>("
        f"static_cast<int32_t>({bits}) >> 3) & 0x8fffffffu), 0) * 0x1p896;"
        for name, bits in (("lo", "w << 16"), ("hi", "w & 0xffff0000u"))))],
}
DIAGNOSTICS = {
    "no_l2_256": [(
        "cp_async16_l2_256(Ms + r * C + mma_matrix_piece(r, piece) * kMPer,",
        "cp_async16(Ms + r * C + mma_matrix_piece(r, piece) * kMPer,")],
    "diag_noconsume": [(
        "      if (active)\n        mma_stage<KC, kDiff>(",
        "      if (active && c0 < 0)\n        mma_stage<KC, kDiff>(")],
    "diag_nomma": [(
        '  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "',
        "  for (int i = 0; i < 4; ++i)\n"
        "    d[i] = __longlong_as_double(__double_as_longlong(d[i]) ^\n"
        "        __double_as_longlong(a[i]) ^ "
        "__double_as_longlong(b[i & 1]));\n"
        '  if (false) asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "'
    )],
    "diag_nowiden": [(WIDEN, "  lo = __hiloint2double(w << 16, 0);\n"
                             "  hi = __hiloint2double(w, 0);")],
}


def variant(name: str, edits: list, src: pathlib.Path) -> pathlib.Path:
    """The source with ``edits`` made, written under OUT as name.cu."""
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {src}")
        text = text.replace(old, new)
    out = OUT / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build(sources: dict) -> dict:
    """sources: name -> .cu path; all nvcc started at once.  Returns
    name -> (library path, ptxas log)."""
    procs = {}
    for name, src in sources.items():
        out = OUT / name / f"libblock_projection_{SUFFIX}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [bp._nvcc(), *bp.NVCC_FLAGS, f"-DREPRO_PAIR={PAIR_INDEX}",
               "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (out, log)
    return built


def load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for kernel, argtypes in bp.ARGTYPES.items():
        fn = getattr(lib, f"{kernel}_{SUFFIX}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_lines(log: str) -> list:
    """The APC pair's instances: 'apc_gather_ring KC=8: 96 regs, spill 0
    B, smem 256 B'."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        if "entry function" in line:
            name = None
            for kn in ("apc_gather", "apc_scatter"):
                for inst in ("_ring_kernel", "_kernel"):
                    tag = f"{kn}{inst}I13__nv_bfloat16dLi"
                    if tag in line:
                        kc = line.split(tag)[1].split("E")[0]
                        name = f"{kn}{inst[:-7]} KC={kc}"
        if name and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        if name and "Used" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            smem = (line.split("bytes smem")[0].split(",")[-1].strip()
                    if "smem" in line else "0")
            out.append(f"{name}: {regs} regs, spill {spill} B, smem {smem} B")
            name = None
    return out


def operands(m, p, n, k, seed):
    """Seeded bf16 A (m, p, n) and B (m, n, p); float64 X (m, k, n) and
    U (m, k, p) as the (m, k, .) views of (k, m, .) tensors, X̄ (k, n);
    drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                               dtype=torch.float64, device="cuda")
    A, B = g(m, p, n).bfloat16(), g(m, n, p).bfloat16()
    X, U = g(k, m, n).transpose(0, 1), g(k, m, p).transpose(0, 1)
    return A, B, X, g(k, n), U


def rel(got, want):
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1)


def check(name, lib, strict):
    """Both instances of the pair against the plain versions; with
    ``strict`` also ring ≡ row dot and a batch row ≡ a k = 1 call."""
    bp._libs[SUFFIX] = lib
    worst = {"apc_gather": 0.0, "apc_scatter": 0.0}
    for (m, p, n) in SHAPES:
        for k in (1, 3, 8, 11):
            A, B, X, Xb, U = operands(m, p, n, k, seed=m * p * n + k)
            runs = {
                "apc_gather": (lambda inst, kk=slice(None): bp.apc_gather(
                    A, X[:, kk], Xb[kk], _instance=inst),
                    ops.apc_gather_ref(A, X, Xb), (A, X, Xb), {}),
                "apc_scatter": (lambda inst, kk=slice(None): bp.apc_scatter(
                    B, X[:, kk], Xb[kk], U[:, kk], 0.9, _instance=inst),
                    ops.apc_scatter_ref(B, X, Xb, U, 0.9), (B, U),
                    dict(scatter="apc_scatter"))}
            for kn, (launch, want, ops_, kw) in runs.items():
                ring = bp.gather_instance(*ops_, **kw) == "ring"
                got = {inst: launch(inst) for inst in ("row_dot", "ring")
                       if inst == "row_dot" or ring}
                torch.cuda.synchronize()
                for inst, y in got.items():
                    e = rel(y, want)
                    assert e < TOL, (name, kn, inst, m, p, n, k, e)
                    worst[kn] = max(worst[kn], e)
                if not strict:
                    continue
                if ring:
                    assert torch.equal(got["ring"], got["row_dot"]), (
                        name, kn, m, p, n, k)
                for inst, y in got.items():
                    row = launch(inst, slice(k - 1, k))
                    assert torch.equal(row, y[:, k - 1:]), (
                        name, kn, inst, m, p, n, k)
    print(f"probe {name}: plain max rel {worst['apc_gather']:.3e} / "
          f"{worst['apc_scatter']:.3e} (tol {TOL:.0e})"
          + ("; ring ≡ row dot; batch row ≡ k = 1 call" if strict else ""),
          flush=True)


def times(libs: dict, reps: int) -> None:
    """CUDA-event medians (ms a call, runs of 10) of each library's
    kernels at the main path's shapes, k = 1 and 8, the libraries in
    turns."""
    order = list(libs) + list(libs)[::-1]
    m, p, n = MAIN
    for k in (1, 8):
        A, B, X, Xb, U = operands(m, p, n, k, seed=k)
        calls = {
            "apc_gather": lambda: bp.apc_gather(A, X, Xb),
            "apc_scatter": lambda: bp.apc_scatter(B, X, Xb, U, 0.9),
            "apc_scatter row dot": lambda: bp.apc_scatter(
                B, X, Xb, U, 0.9, _instance="row_dot")}
        samples = {(name, kn): [] for name in libs for kn in calls}
        for name in libs:                          # warm every library
            bp._libs[SUFFIX] = libs[name]
            for fn in calls.values():
                fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            for name in order:
                bp._libs[SUFFIX] = libs[name]
                for kn, fn in calls.items():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(10):
                        fn()
                    end.record()
                    end.synchronize()
                    samples[(name, kn)].append(start.elapsed_time(end) / 10)
        mkn, mkp, mpn = m * k * n, m * k * p, m * p * n
        gather = (2 * mpn + 8 * (mkn + k * n + mkp)) / HBM * 1e3
        scatter = (2 * mpn + 8 * (2 * mkn + k * n + mkp)) / HBM * 1e3
        for (name, kn), t in samples.items():
            ms = float(np.median(t))
            b = gather if kn == "apc_gather" else scatter
            print(f"probe time m={m} p={p} n={n} k={k} {name} {kn}: "
                  f"{ms:.4f} ms (bound {b:.4f} ms, {b / ms:.1%})",
                  flush=True)
        del A, B, X, Xb, U


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="another checkout's root: its bf16/f64 library "
                    "built and timed beside this one")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also build and time the DIAGNOSTICS variants")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mma_widen: no CUDA device", file=sys.stderr)
        return 1
    src = bp.CSRC / "block_projection.cu"
    sources = {}
    if args.baseline is not None:
        sources["baseline"] = (
            args.baseline / "src/repro_torch/kernels/csrc/block_projection.cu")
    sources["mma"] = src
    edits = dict(VARIANTS, **(DIAGNOSTICS if args.diagnostics else {}))
    for name, pairs in edits.items():
        sources[name] = variant(name, pairs, src)
    t = time.time()
    built = build(sources)
    print(f"probe build: {time.time() - t:.2f} s, {len(built)} libraries",
          flush=True)
    for name, (_, log) in built.items():
        print(f"probe ptxas {name}: " + "; ".join(ptxas_lines(log)),
              flush=True)
    libs = {name: load(path) for name, (path, _) in built.items()}
    for name, lib in libs.items():
        if not name.startswith("diag"):
            check(name, lib, strict=name != "baseline")
    times(libs, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
