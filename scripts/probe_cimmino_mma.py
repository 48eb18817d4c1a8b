#!/usr/bin/env python3
"""Probe of the Cimmino pair on the FP64 tensor cores on one NVIDIA GPU:
the bf16/float64 ``cimmino_gather`` and ``cimmino_scatter`` and the
float64 ``cimmino_scatter`` (``block_projection.MMA_FORMS``).

    python3 scripts/probe_cimmino_mma.py [--baseline DIR] [--reps 15]

Builds the float64 and the bf16/float64 libraries of
``kernels/csrc/block_projection.cu`` (``new``), as VARIANTS write it
from the source (``dfma``: the float64 scatter ring's consumers sum each
of their fragment's 8 outputs by DFMA, one chain over the columns in
order, in place of the mma; ``shares``: the float64 form's blocks take
equal shares of the rows, cut into tiles of at most 256, in place of
whole tiles), and, with ``--baseline``, the same two from
another checkout's source (``baseline``), under ``build/probe_cimmino/``,
all ``nvcc`` processes at once.  Then:

* the new libraries' instances (ring and row dot) of the three kernels,
  and of the bf16/float64 APC pair beside them, against their plain
  versions (``ops.*_ref``) within 1e-12 of max|plain| + 1, at ragged
  shapes and at the main path's (m 16, p 2048, n 16384), k = 1, 3, 8,
  11; the two instances bit-identical and a batch row bit-identical to a
  k = 1 call; each variant's float64 ``cimmino_scatter`` ring against
  the plain version (``shares`` also ≡ the row dot);
* CUDA-event medians (runs of 10 back-to-back calls) at the main path's
  shapes, k = 1 and 8, of each library's Cimmino kernels, both instances
  of the float64 ``cimmino_scatter``, and ``torch.matmul(V, Bᵀ)`` in
  float64, in turns (the libraries first to last, then last to first),
  each beside its bytes bound at 3.35 TB/s.

Prints each library's ptxas lines for the Cimmino pair, the card's
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

PAIRS = {"f64": (torch.float64, torch.float64),
         "bf16_f64": (torch.bfloat16, torch.float64)}
OUT = ROOT / "build" / "probe_cimmino"
HBM = 3.35e12
TOL = 1e-12
MAIN = (16, 2048, 16384)
# (m, p, n): p = 130 and 100 leave a float64 stage's last k-step half
# full; p = 7 and 1 take the row dot
SHAPES = ((3, 7, 130), (3, 64, 136), (2, 100, 1000), (3, 130, 64),
          (2, 1, 8), (2, 300, 520), MAIN)
# name -> the (text, replacement) pairs that write the variant from the
# source
MMA_WIDE = """      mma_rows(acc, f, b);
    } else {"""
VARIANTS = {
    "dfma": [(MMA_WIDE, """      (void)f;
      const double* xr =
          reinterpret_cast<const double*>(stage + Cfg::kMatrixBytes);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (8 * s + 2 * c >= nv) break;
        double2 v[2] = {};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 2 * t + e;
          if (kk < KC)
            v[e] = *reinterpret_cast<const double2*>(
                xr + kk * Cfg::kCols + 2 * mma_operand_piece(kk, 4 * s + c));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + 8 * j + g;
          const double2 a = *reinterpret_cast<const double2*>(
              stage + r * Cfg::kRowBytes +
              Cfg::matrix_piece(r, 4 * s + c) * 16);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            double& d = acc[j >> 1][2 * (j & 1) + e];
            d = fma(a.x, v[e].x, d);
            d = fma(a.y, v[e].y, d);
          }
        }
      }
    } else {""")],
    "shares": [("""  if constexpr (kMma) {
    // whole tiles:""", """  if constexpr (kMma && sizeof(TM) == 2) {
    // whole tiles:""")],
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
    """sources: name -> .cu path; every (name, pair) library's nvcc
    started at once.  Returns (name, suffix) -> (library, ptxas log)."""
    procs = {}
    index = {sfx: i for i, sfx in enumerate(bp.PAIRS.values())}
    for name, src in sources.items():
        for sfx in PAIRS:
            out = OUT / name / f"libblock_projection_{sfx}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            cmd = [bp._nvcc(), *bp.NVCC_FLAGS, f"-DREPRO_PAIR={index[sfx]}",
                   "-o", str(out), str(src)]
            procs[(name, sfx)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for key, (out, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        built[key] = (out, log)
    return built


def load(path, sfx) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for kernel, argtypes in bp.ARGTYPES.items():
        fn = getattr(lib, f"{kernel}_{sfx}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gather_ring_smem.argtypes = bp.RING_SMEM_ARGTYPES
    lib.gather_ring_smem.restype = ctypes.c_int64
    return lib


def ptxas_lines(log: str) -> list:
    """The Cimmino pair's instances: 'cimmino_scatter_ring KC=8: 96 regs,
    spill 0 B, smem 256 B'."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        if "entry function" in line:
            name = None
            for kn in ("cimmino_gather", "cimmino_scatter"):
                for inst in ("_ring_kernel", "_kernel"):
                    if f"{len(kn) + len(inst)}{kn}{inst}I" in line:
                        kc = line.split(f"{kn}{inst}I")[1].split("Li")[1]
                        name = f"{kn}{inst[:-7]} KC={kc.split('E')[0]}"
        if name and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        if name and "Used" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            smem = (line.split("bytes smem")[0].split(",")[-1].strip()
                    if "smem" in line else "0")
            out.append(f"{name}: {regs} regs, spill {spill} B, smem {smem} B")
            name = None
    return out


def operands(mdt, m, p, n, k, seed):
    """Seeded A (m, p, n) and B (m, n, p) in ``mdt``; float64 X (m, k, n)
    and V (m, k, p) as the (m, k, .) views of (k, m, .) tensors, X̄
    (k, n); drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                               dtype=torch.float64, device="cuda")
    A, B = g(m, p, n).to(mdt), g(m, n, p).to(mdt)
    X, V = g(k, m, n).transpose(0, 1), g(k, m, p).transpose(0, 1)
    return A, B, X, g(k, n), V


def rel(got, want):
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1)


# kernel -> (launch(instance, batch rows), the plain version, the
# operands gather_instance reads) from the operands
CASES = {
    "apc_gather": lambda A, B, X, Xb, V: (
        lambda inst, kk=slice(None): bp.apc_gather(A, X[:, kk], Xb[kk],
                                                   _instance=inst),
        ops.apc_gather_ref(A, X, Xb), (A, X, Xb)),
    "apc_scatter": lambda A, B, X, Xb, V: (
        lambda inst, kk=slice(None): bp.apc_scatter(
            B, X[:, kk], Xb[kk], V[:, kk], 0.9, _instance=inst),
        ops.apc_scatter_ref(B, X, Xb, V, 0.9), (B, V)),
    "cimmino_gather": lambda A, B, X, Xb, V: (
        lambda inst, kk=slice(None): bp.cimmino_gather(A, Xb[kk],
                                                       _instance=inst),
        ops.cimmino_gather_ref(A, Xb), (A, Xb)),
    "cimmino_scatter": lambda A, B, X, Xb, V: (
        lambda inst, kk=slice(None): bp.cimmino_scatter(B, V[:, kk],
                                                        _instance=inst),
        ops.cimmino_scatter_ref(B, V), (B, V)),
}


def check(libs: dict) -> None:
    """Both instances of each kernel of bp.MMA_FORMS against the plain
    versions, ring ≡ row dot and a batch row ≡ a k = 1 call."""
    bp._libs.update(libs)
    worst = {}
    for kn, sfx in bp.MMA_FORMS:
        mdt = PAIRS[sfx][0]
        for (m, p, n) in SHAPES:
            for k in (1, 3, 8, 11):
                A, B, X, Xb, V = operands(mdt, m, p, n, k, m * p * n + k)
                launch, want, ops_ = CASES[kn](A, B, X, Xb, V)
                ring = bp.gather_instance(*ops_) == "ring"
                got = {inst: launch(inst) for inst in ("row_dot", "ring")
                       if inst == "row_dot" or ring}
                torch.cuda.synchronize()
                for inst, y in got.items():
                    e = rel(y, want)
                    assert e < TOL, (kn, sfx, inst, m, p, n, k, e)
                    worst[(kn, sfx)] = max(worst.get((kn, sfx), 0.0), e)
                if ring:
                    assert torch.equal(got["ring"], got["row_dot"]), (
                        kn, sfx, m, p, n, k)
                for inst, y in got.items():
                    row = launch(inst, slice(k - 1, k))
                    assert torch.equal(row, y[:, k - 1:]), (
                        kn, sfx, inst, m, p, n, k)
    for (kn, sfx), e in worst.items():
        print(f"probe check {kn} {sfx}: plain max rel {e:.3e} (tol "
              f"{TOL:.0e}); ring ≡ row dot; batch row ≡ k = 1 call",
              flush=True)


def check_variant(name: str, libs: dict) -> None:
    """A variant's float64 cimmino_scatter ring against the plain
    version."""
    bp._libs.update(libs)
    worst = 0.0
    for (m, p, n) in SHAPES:
        for k in (1, 3, 8, 11):
            _, B, _, _, V = operands(torch.float64, m, p, n, k, m * p * n + k)
            if bp.gather_instance(B, V) != "ring":
                continue
            ring = bp.cimmino_scatter(B, V, _instance="ring")
            e = rel(ring, ops.cimmino_scatter_ref(B, V))
            assert e < TOL, (name, m, p, n, k, e)
            worst = max(worst, e)
            if name != "dfma":          # the mma's sums, tiled otherwise
                assert torch.equal(ring, bp.cimmino_scatter(
                    B, V, _instance="row_dot")), (name, m, p, n, k)
    print(f"probe check {name} cimmino_scatter f64 ring: plain max rel "
          f"{worst:.3e} (tol {TOL:.0e})"
          + ("" if name == "dfma" else "; ring ≡ row dot"), flush=True)


def times(libs: dict, reps: int) -> None:
    """CUDA-event medians (ms a call, runs of 10) at the main path's
    shapes, k = 1 and 8, the libraries in turns."""
    order = list(libs) + list(libs)[::-1]
    m, p, n = MAIN
    for k in (1, 8):
        f64 = operands(torch.float64, m, p, n, k, seed=k)
        mix = operands(torch.bfloat16, m, p, n, k, seed=k)
        calls = {
            "f64 cimmino_scatter ring": lambda: bp.cimmino_scatter(
                f64[1], f64[4], _instance="ring"),
            "f64 cimmino_scatter row dot": lambda: bp.cimmino_scatter(
                f64[1], f64[4], _instance="row_dot"),
            "bf16_f64 cimmino_gather ring": lambda: bp.cimmino_gather(
                mix[0], mix[3], _instance="ring"),
            "bf16_f64 cimmino_gather row dot": lambda: bp.cimmino_gather(
                mix[0], mix[3], _instance="row_dot"),
            "bf16_f64 cimmino_scatter ring": lambda: bp.cimmino_scatter(
                mix[1], mix[4], _instance="ring"),
            "bf16_f64 cimmino_scatter row dot": lambda: bp.cimmino_scatter(
                mix[1], mix[4], _instance="row_dot"),
            "bf16_f64 apc_scatter ring": lambda: bp.apc_scatter(
                mix[1], mix[2], mix[3], mix[4], 0.9, _instance="ring")}
        library = lambda: torch.matmul(  # noqa: E731
            f64[4], f64[1].transpose(1, 2))
        samples = {(name, kn): [] for name in libs for kn in calls}
        samples[("torch", "f64 torch.matmul(V, Bᵀ)")] = []
        for name in libs:                          # warm every library
            bp._libs.update(libs[name])
            for fn in calls.values():
                fn()
        library()
        torch.cuda.synchronize()

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 10

        for _ in range(reps):
            for name in order:
                bp._libs.update(libs[name])
                for kn, fn in calls.items():
                    samples[(name, kn)].append(timed(fn))
            samples[("torch", "f64 torch.matmul(V, Bᵀ)")].append(
                timed(library))
        mkn, mkp, mpn = m * k * n, m * k * p, m * p * n
        bound = {"f64 cimmino_scatter": 8 * (mpn + mkp + mkn),
                 "bf16_f64 cimmino_gather": 2 * mpn + 8 * (k * n + mkp),
                 "bf16_f64 cimmino_scatter": 2 * mpn + 8 * (mkp + mkn),
                 "bf16_f64 apc_scatter": 2 * mpn + 8 * (2 * mkn + k * n
                                                        + mkp),
                 "f64 torch.matmul(V, Bᵀ)": 8 * (mpn + mkp + mkn)}
        for (name, kn), t in samples.items():
            ms = float(np.median(t))
            b = next(v for key, v in bound.items()
                     if kn.startswith(key)) / HBM * 1e3
            print(f"probe time m={m} p={p} n={n} k={k} {name} {kn}: "
                  f"{ms:.4f} ms (bound {b:.4f} ms, {b / ms:.1%})",
                  flush=True)
        del f64, mix


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="another checkout's root: its float64 and "
                    "bf16/float64 libraries built and timed beside these")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_cimmino_mma: no CUDA device", file=sys.stderr)
        return 1
    sources = {}
    if args.baseline is not None:
        sources["baseline"] = (
            args.baseline / "src/repro_torch/kernels/csrc/block_projection.cu")
    sources["new"] = bp.CSRC / "block_projection.cu"
    for name, edits in VARIANTS.items():
        sources[name] = variant(name, edits, sources["new"])
    t = time.time()
    built = build(sources)
    print(f"probe build: {time.time() - t:.2f} s, {len(built)} libraries",
          flush=True)
    for (name, sfx), (_, log) in built.items():
        print(f"probe ptxas {name} {sfx}: " + "; ".join(ptxas_lines(log)),
              flush=True)
    libs = {}
    for (name, sfx), (path, _) in built.items():
        libs.setdefault(name, {})[sfx] = load(path, sfx)
    new = libs["new"]
    for sfx, lib in new.items():
        size = PAIRS[sfx][0].itemsize
        for k in (1, 8):
            smem = lib.gather_ring_smem(size, 8, k, bp.FORMS["cimmino_mma"])
            print(f"probe smem new {sfx} k={k}: cimmino_mma {smem} B",
                  flush=True)
    failed = None
    try:
        check(new)
        for name in VARIANTS:
            check_variant(name, libs[name])
    except AssertionError as e:        # timed all the same, then reported
        failed = e
        print(f"probe check FAILED: {e!r}", flush=True)
    times(libs, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi or "nvidia-smi: no output")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
