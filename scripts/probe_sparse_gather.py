#!/usr/bin/env python3
"""Probe of the two sparse gathers (``sparse_gather``,
``sparse_cimmino_gather``) on one NVIDIA GPU, in all five dtype forms.

    python3 scripts/probe_sparse_gather.py [--baseline DIR] [--reps 15]

Builds the libraries of ``kernels/csrc/block_projection.cu`` (``new``:
the support operand written by a pre-pass, then the Cimmino-form ring
over vals with it, 256-row tensor-core tiles in bf16/float64 and
float64), the variants VARIANTS writes from the source (``dfma``: the
float64 sparse gathers on the 64-row DFMA ring, kSparseMma bf16/f64 alone;
``producer``: the Cimmino gather's 256-row tensor-core ring gathering
X̄'s support columns element by element in its producers, no pre-pass;
``nopre``: the ring without its pre-pass, timed only, its operand
unwritten; ``nopdl``: the ring launched plainly after the pre-pass, not
as its programmatic dependent),
and, with ``--baseline``, another checkout's (``baseline``: the parent's
64-row rings with the element-wise gather in their producers), under
``build/probe_sparse/``, all ``nvcc`` processes at once.  Then:

* ``new``'s instances (ring and row dot) of both gathers in every form
  against their plain versions (``ops.*_ref``) within 1e-12 (float64),
  2e-5 (float32), 8e-2 (bf16 outputs) of max|plain| + 1, at an odd
  support width (the row dot), a small even one and the sparse path's
  (m 16, p 2048, w 2064 of a band of n = 32768, the padding slots'
  values zeroed as as_sparse leaves them), k = 1, 3, 8, 11; ring ≡ row
  dot and a batch row ≡ a k = 1 call, bit for bit; each variant's ring
  against the plain version (``producer`` ≡ ``new``'s ring);
* CUDA-event medians at the sparse path's shapes, k = 1 and 8, of
  runs of 10 back-to-back calls and of the replay of 10 calls captured
  in a CUDA graph (the device's time, the host's launch work out of
  it), of each library's two gathers in every form it holds (the
  launcher's instance: the ring), and of
  ``torch.bmm`` on the support operands gathered beforehand where the
  matrix and the operands share a dtype, in turns (the libraries first
  to last, then last to first), each beside its bytes bound at 3.35
  TB/s: vals, cols, the support columns of X̄ (and X) and U, each read or
  written once (the pre-pass's buffer not counted).

Prints each library's ptxas lines for the sparse gathers, the card's
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

from repro_torch.core import partition  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OUT = ROOT / "build" / "probe_sparse"
HBM = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 2e-5, torch.bfloat16: 8e-2}
KERNELS = ("sparse_gather", "sparse_cimmino_gather")
# the sparse path's banded system (chip_smoke.py SPARSE) and two smaller
# bands: an odd support width (f64 rows of 71: the row dot) and an even
SPARSE = dict(n=32768, m=16, bandwidth=8)
SHAPES = (dict(n=130, m=2, bandwidth=6), dict(n=1024, m=4, bandwidth=8),
          SPARSE)
# the pairs each library is built for
LIBS = {"baseline": tuple(bp.PAIRS.values()), "new": tuple(bp.PAIRS.values()),
        "dfma": ("f64",), "producer": ("f64", "bf16_f64"),
        "nopre": tuple(bp.PAIRS.values()),
        "nopdl": tuple(bp.PAIRS.values())}
# name -> the (text, replacement) pairs that write the variant from the
# source
VARIANTS = {
    "dfma": [("""    kMmaForm<TM, T> ||
    (std::is_same_v<TM, double> && std::is_same_v<T, double>);""",
              "    kMmaForm<TM, T>;")],
    "producer": [
        ("""      if (lane < opieces)
        cp_async16(dst + (kMma ? mma_operand_piece(kk, lane) : lane) * kPer,
                   src + c0 + lane * kPer);""",
         """      if (lane < opieces) {
        T* d = dst + (kMma ? mma_operand_piece(kk, lane) : lane) * kPer;
        bool gathered = false;
        if constexpr (kPerWorker && kMma) {
          if (X != nullptr) {        // X carries cols: gather X̄ here
            const int64_t* cw = reinterpret_cast<const int64_t*>(X) +
                                tl.w * n + c0 + lane * kPer;
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              cp_async_element(d + e, src - tl.w * sxb_w + cw[e]);
            gathered = true;
          }
        }
        if (!gathered) cp_async16(d, src + c0 + lane * kPer);
      }"""),
        ("""                                  int64_t so_k, int64_t su_w, int64_t su_k) {
  sparse_ring<TM, T, KC>(vals, O, U, m, p, w, k, so_w, so_k, su_w, su_k);
}""",
         """                                  int64_t so_k, int64_t su_w, int64_t su_k,
                                  const int64_t* __restrict__ cols) {
  if constexpr (kSparseMma<TM, T>)
    ring_run<TM, T, KC, false, true, true>(
        vals, reinterpret_cast<const T*>(cols), O, m, p, w, k, 0, 0, so_w,
        so_k, MmaStore{U, su_w, su_k});
  else
    sparse_ring<TM, T, KC>(vals, O, U, m, p, w, k, so_w, so_k, su_w, su_k);
}"""),
        ("""      constexpr auto kernel = kDiff
                                  ? &sparse_gather_ring_kernel<TM, T, KC>
                                  : &sparse_cimmino_gather_ring_kernel<TM, T, KC>;
      launch_ring<kernel, KC, kMma, true>(
          Ring<TM, TA, KC, false, kMma>::kSmem, m, p, k, s, M, Ot, Ut, m, p,
          w, k, k * wp, wp, su_w, su_k);
      return;""",
         """      constexpr int smem = Ring<TM, TA, KC, false, kMma>::kSmem;
      if constexpr (kDiff)
        launch_ring<&sparse_gather_ring_kernel<TM, T, KC>, KC, kMma>(
            smem, m, p, k, s, M, Ot, Ut, m, p, w, k, k * wp, wp, su_w, su_k);
      else if constexpr (kMma)
        launch_ring<&sparse_cimmino_gather_ring_kernel<TM, T, KC>, KC,
                    kMma>(smem, m, p, k, s, M, static_cast<const TA*>(Xbar),
                          Ut, m, p, w, k, int64_t{0}, sxb_k, su_w, su_k,
                          static_cast<const int64_t*>(cols));
      else
        launch_ring<&sparse_cimmino_gather_ring_kernel<TM, T, KC>, KC,
                    kMma>(smem, m, p, k, s, M, Ot, Ut, m, p, w, k, k * wp,
                          wp, su_w, su_k,
                          static_cast<const int64_t*>(nullptr));
      return;"""),
        ("  if (wp > 0) {",
         "  if (wp > 0 && (kDiff || !kSparseMma<TM, T> || instance != kRing)) {"),
    ],
    "nopre": [("  if (wp > 0) {", "  if (wp > 0 && instance != kRing) {")],
    "nopdl": [("launch_ring<kernel, KC, kMma, true>(",
               "launch_ring<kernel, KC, kMma, false>(")],
}
# the variants whose results are not checked (an unwritten operand)
UNCHECKED = ("nopre",)
_P, _I = ctypes.c_void_p, ctypes.c_int64
# the entries' argument types: the support-buffer ABI (this source) and
# the parent's (no buffer, no wp)
ABI = {"new": {"sparse_gather": [_P] * 6 + [_I] * 12 + [_P],
               "sparse_cimmino_gather": [_P] * 5 + [_I] * 10 + [_P]},
       "old": {"sparse_gather": [_P] * 5 + [_I] * 11 + [_P],
               "sparse_cimmino_gather": [_P] * 4 + [_I] * 9 + [_P]}}


def variant(name: str, edits: list, src: pathlib.Path) -> pathlib.Path:
    """The source with ``edits`` made, written under OUT as name.cu."""
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {src}")
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
        for sfx in LIBS[name]:
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


class Lib:
    """One library's two sparse gathers, called with its own ABI."""

    def __init__(self, path, sfx, abi):
        self.lib, self.sfx, self.abi = ctypes.CDLL(str(path)), sfx, abi
        for kn in KERNELS:
            fn = getattr(self.lib, f"{kn}_{sfx}")
            fn.argtypes = ABI[abi][kn]
            fn.restype = ctypes.c_int

    def __call__(self, kn, vals, cols, X, Xb, inst="ring"):
        """U of kernel ``kn`` (X None: the Cimmino gather) on X (m, k, n)
        and X̄ (k, n), the instance ``inst``."""
        m, p, w = vals.shape
        k = Xb.shape[0]
        U = torch.empty((m, k, p), dtype=Xb.dtype, device=vals.device)
        head = [vals.data_ptr(), cols.data_ptr()]
        if kn == "sparse_gather":
            head += [X.data_ptr()]
        head += [Xb.data_ptr(), U.data_ptr()]
        if self.abi == "new":
            O = bp.support_buffer(m, k, w, Xb.dtype, vals.device)
            head += [O.data_ptr()]
            sizes = [m, p, w, O.shape[-1], k]
        else:
            sizes = [m, p, w, k]
        strides = ([X.stride(0), X.stride(1)] if kn == "sparse_gather"
                   else []) + [Xb.stride(0), U.stride(0), U.stride(1)]
        err = getattr(self.lib, f"{kn}_{self.sfx}")(
            *head, *sizes, *strides, bp.INSTANCES[inst], 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kn}_{self.sfx}: CUDA error {err}")
        return U


def ptxas_lines(log: str) -> list:
    """The sparse gathers' instances and the pre-pass: 'sparse_gather_ring
    KC=8: 96 regs, spill 0 B, smem 256 B'."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        if "entry function" in line:
            name = None
            for kn in KERNELS + ("support_operand",):
                for inst in ("_ring_kernel", "_kernel"):
                    tag = f"{len(kn) + len(inst)}{kn}{inst}I"
                    if tag in line:
                        rest = line.split(tag)[1]
                        kc = (rest.split("Li")[1].split("E")[0]
                              if "Li" in rest else "-")
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


def system(n, m, bandwidth, seed=11):
    """A band's support (cols, as as_sparse pads it) and seeded float64
    vals (m, p, w) on the card, the padding slots' values zero."""
    p = n // m
    band = np.zeros((m, n), bool)
    for i in range(m):
        band[i, max(i * p - bandwidth, 0):(i + 1) * p + bandwidth] = True
    cols = partition.support_cols(band)
    vals = np.random.default_rng(seed).standard_normal((m, p, cols.shape[1]))
    for i in range(m):
        _, inv, counts = np.unique(cols[i], return_inverse=True,
                                   return_counts=True)
        vals[i][:, counts[inv] > 1] = 0.0
    return (torch.as_tensor(cols, device="cuda"),
            torch.as_tensor(vals, device="cuda"))


def operands(pair, n, m, k, seed):
    """X (m, k, n) as the (m, k, n) view of a (k, m, n) tensor and X̄
    (k, n), seeded, in the pair's compute dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((k, m, n), generator=gen, dtype=torch.float64,
                    device="cuda").to(pair[1]).transpose(0, 1)
    Xb = torch.randn((k, n), generator=gen, dtype=torch.float64,
                     device="cuda").to(pair[1])
    return X, Xb


def rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1)


def plain(kn, vals, cols, X, Xb):
    return (ops.sparse_gather_ref(vals, cols, X, Xb) if kn == "sparse_gather"
            else ops.sparse_cimmino_gather_ref(vals, cols, Xb))


def check(libs: dict) -> None:
    """``new``'s two gathers in every form against the plain versions,
    ring ≡ row dot and a batch row ≡ a k = 1 call; each variant's ring
    against the plain version, the producer variant's ≡ ``new``'s."""
    new = libs["new"]
    worst = {}
    for spec in SHAPES:
        cols, vals64 = system(**spec)
        for pair, sfx in bp.PAIRS.items():
            vals = vals64.to(pair[0])
            ring = bp.gather_instance(vals) == "ring"
            for k in (1, 3, 8, 11):
                X, Xb = operands(pair, spec["n"], spec["m"], k,
                                 spec["n"] + k)
                for kn in KERNELS:
                    want = plain(kn, vals, cols, X, Xb)
                    got = {inst: new[sfx](kn, vals, cols, X, Xb, inst)
                           for inst in ("row_dot", "ring")
                           if inst == "row_dot" or ring}
                    torch.cuda.synchronize()
                    for inst, u in got.items():
                        e = rel(u, want)
                        assert u.dtype == pair[1] and e < TOL[pair[1]], (
                            kn, sfx, inst, spec, k, e)
                        worst[(kn, sfx)] = max(worst.get((kn, sfx), 0.0), e)
                        row = new[sfx](kn, vals, cols, X[:, k - 1:],
                                       Xb[k - 1:], inst)
                        assert torch.equal(row, u[:, k - 1:]), (
                            kn, sfx, inst, spec, k)
                    if ring:
                        assert torch.equal(got["ring"], got["row_dot"]), (
                            kn, sfx, spec, k)
                    for name, lib in libs.items():
                        if name in ("new", "baseline") + UNCHECKED \
                                or sfx not in lib or not ring:
                            continue
                        if name == "producer" and kn != "sparse_cimmino_gather":
                            continue
                        u = lib[sfx](kn, vals, cols, X, Xb)
                        e = rel(u, want)
                        assert e < TOL[pair[1]], (name, kn, sfx, spec, k, e)
                        if name in ("producer", "nopdl"):
                            assert torch.equal(u, got["ring"]), (
                                name, kn, sfx, spec, k)
                        worst[(name, kn, sfx)] = max(
                            worst.get((name, kn, sfx), 0.0), e)
    for key, e in worst.items():
        print(f"probe check {' '.join(key)}: plain max rel {e:.3e}"
              + ("; ring ≡ row dot; batch row ≡ k = 1 call"
                 if len(key) == 2 else "")
              + ("; ≡ new ring" if key[0] in ("producer", "nopdl")
                 else ""),
              flush=True)


def times(libs: dict, reps: int) -> None:
    """CUDA-event medians (ms a call, runs of 10) at the sparse path's
    shapes, k = 1 and 8, the libraries in turns."""
    order = list(libs) + list(libs)[::-1]
    cols, vals64 = system(**SPARSE)
    m, p, w = vals64.shape
    n = SPARSE["n"]
    for k in (1, 8):
        calls, bounds = {}, {}
        for pair, sfx in bp.PAIRS.items():
            vals = vals64.to(pair[0])
            X, Xb = operands(pair, n, m, k, seed=k)
            idx = cols[:, None, :].expand(m, k, w)
            xs = pair[1].itemsize
            mkw, mkp = m * k * w, m * k * p
            for kn in KERNELS:
                for name in libs:
                    if sfx not in libs[name] or (
                            name == "producer"
                            and (kn != "sparse_cimmino_gather" or k != 1)):
                        continue
                    calls[(name, sfx, kn)] = (
                        lambda lib=libs[name][sfx], kn=kn, v=vals, X=X,
                        Xb=Xb: lib(kn, v, cols, X, Xb))
                bounds[(sfx, kn)] = (
                    pair[0].itemsize * m * p * w + 8 * m * w
                    + xs * ((2 if kn == "sparse_gather" else 1) * mkw + mkp)
                ) / HBM * 1e3
                if pair[0] == pair[1]:
                    op = (torch.take_along_dim(Xb - X, idx, dim=-1)
                          if kn == "sparse_gather" else
                          torch.take_along_dim(Xb.expand(m, k, n), idx,
                                               dim=-1))
                    calls[("torch", sfx, kn)] = (
                        lambda op=op, v=vals: torch.bmm(op, v.transpose(1, 2)))
        samples = {key: [] for key in calls}
        for fn in calls.values():                   # warm every call
            fn()
        torch.cuda.synchronize()

        def timed(fn, n=10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 10

        graphs = {}
        for key, fn in calls.items():               # 10 calls a graph
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    for _ in range(10):
                        fn()
                graphs[key] = graph.replay
            except RuntimeError as e:          # timed eagerly all the same
                print(f"probe capture {key} failed: {e!r}", flush=True)
                graphs[key] = lambda: None
            torch.cuda.synchronize()
        gsamples = {key: [] for key in calls}
        for _ in range(reps):
            for name in order + ["torch"]:
                for key, fn in calls.items():
                    if key[0] == name:
                        samples[key].append(timed(fn))
                        gsamples[key].append(timed(graphs[key], 1))
        for (name, sfx, kn), t in sorted(samples.items(),
                                         key=lambda kv: (kv[0][2], kv[0][1],
                                                         kv[0][0])):
            ms = float(np.median(t))
            gms = float(np.median(gsamples[(name, sfx, kn)]))
            b = bounds[(sfx, kn)]
            what = "torch.bmm (operands gathered beforehand)" \
                if name == "torch" else f"{name} ring"
            print(f"probe time m={m} p={p} w={w} n={n} k={k} {sfx} {kn} "
                  f"{what}: {ms:.4f} ms (bound {b:.4f} ms, {b / ms:.1%}); "
                  f"in a CUDA graph {gms:.4f} ms ({b / gms:.1%})",
                  flush=True)
        del calls, graphs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="another checkout's root: its libraries built and "
                    "timed beside these")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sparse_gather: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
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
    libs = {}
    for (name, sfx), (path, log) in built.items():
        print(f"probe ptxas {name} {sfx}: " + "; ".join(ptxas_lines(log)),
              flush=True)
        abi = "new" if "void* O" in sources[name].read_text() else "old"
        libs.setdefault(name, {})[sfx] = Lib(path, sfx, abi)
        if name == "new":
            lib = libs[name][sfx].lib
            lib.gather_ring_smem.argtypes = bp.RING_SMEM_ARGTYPES
            lib.gather_ring_smem.restype = ctypes.c_int64
            pair = next(pr for pr, s in bp.PAIRS.items() if s == sfx)
            smem = [lib.gather_ring_smem(pair[0].itemsize,
                                         pair[1].itemsize, k,
                                         bp.FORMS["sparse"]) for k in (1, 8)]
            print(f"probe smem new {sfx}: sparse k=1 {smem[0]} B, k=8 "
                  f"{smem[1]} B", flush=True)
    failed = None
    try:
        check(libs)
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
