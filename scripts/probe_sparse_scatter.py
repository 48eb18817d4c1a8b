#!/usr/bin/env python3
"""Probe of ``sparse_scatter`` on one NVIDIA GPU, both forms (APC: X and
X̄ given; Cimmino) in all five dtype forms.

    python3 scripts/probe_sparse_scatter.py [--baseline DIR] [--reps 15]

Builds the libraries of ``kernels/csrc/block_projection.cu`` (``new``:
the tensor-core ring of 256-row tiles in float64, bf16/float64 (FP64
mma) and all-bf16 (bf16 mma, float32 sums), the epilogue from the
fragment at ``cols``, the rows cut in 16-row groups evenly over the
blocks, a tile running on into the next unit's rows; the
64-row FFMA ring in float32 and bf16/float32, X and X̄ copied at
``cols`` before the reduction tree), the variants VARIANTS writes from
the source (``dfma``: float64 on the 64-row DFMA ring; ``ffma``: all-bf16
on the 64-row FFMA ring; ``whole``: the tensor-core forms on equal
counts of whole tiles a block, the dense kernels' walk, each tile within
one unit; ``late``: the tensor-core epilogue reading cols, X and X̄ after
the tile's stages, not as it starts; ``seg256``: float64 stages of 256
bytes of each of the tile's rows, not 128, in a 216 KiB budget;
``pf512``, ``pf1k``: float64 producers also prefetching each row's next
512 bytes every 4 stages, or its next 1 KiB every 8, into L2 with
cp.async.bulk.prefetch), and, with
``--baseline``, another checkout's (``baseline``: the parent's 64-row
DFMA/FFMA rings in every form), under ``build/probe_scatter/``, all
``nvcc`` processes at once.  Then:

* ``new``'s two instances (ring and row dot) of both forms in every pair
  against the plain version (``ops.sparse_scatter_ref``) within 1e-12
  (float64), 2e-5 (float32), 8e-2 (bf16) of max|plain| + 1, at the
  banded corner systems (an odd support width takes the row dot), the
  sparse path's (m 16, p 2048, w 2064 of a band of n = 32768) and k = 1,
  3, 8, 11; ring ≡ row dot bit for bit (bf16/float32: the ring ≡ the
  float32 ring on the matrix widened, its packed row dot summing in
  another order) and a batch row ≡ a k = 1 call; each variant's ring
  against the plain version, ``whole`` ≡ ``new`` bit for bit;
* CUDA-event medians at the sparse path's shapes, k = 1 and 8, of runs
  of 10 back-to-back calls (eager) and of the replay of 10 calls
  captured in a CUDA graph (the device's time) of each library's
  instances in every form it holds (the ring; at k = 1 the row dot
  too, the parent's launcher's instance in float64 and float32), and of
  ``torch.bmm`` of U and Bvals (the scatter left out) where the matrix
  and the operands share a dtype, in turns (the libraries first to last,
  then last to first), each beside its bytes bound at 3.35 TB/s: Bvals,
  cols, U, the output's support columns and, in the APC form, X and X̄
  there, each read or written once;
* the slowest block's rows and tiles against the mean, at the sparse
  path's shapes, of the span walk and of equal counts of whole tiles
  (arithmetic of the walks, csrc SpanWalk and MmaWalk, on the card's
  SMs).

Prints each library's ptxas lines for the sparse scatter's instances,
the card's ``nvidia-smi`` line, and exits non-zero on any failure or
without a card.
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

OUT = ROOT / "build" / "probe_scatter"
HBM = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 2e-5, torch.bfloat16: 8e-2}
GAMMA = 0.9
# the sparse path's banded system (chip_smoke.py SPARSE) and the banded
# corner systems of chip_smoke.py's phase 2 (odd support widths take the
# row dot; n = 24 / m = 24 has p = 1)
SPARSE = dict(n=32768, m=16, bandwidth=8)
SHAPES = (dict(n=130, m=2, bandwidth=6), dict(n=24, m=24, bandwidth=2),
          dict(n=192, m=4, bandwidth=6), dict(n=1024, m=4, bandwidth=8),
          SPARSE)
ALL = tuple(bp.PAIRS.values())
# the pairs each library is built for
LIBS = {"baseline": ALL, "new": ALL, "dfma": ("f64",),
        "ffma": ("bf16_bf16",),
        "whole": ("f64", "bf16_f64", "bf16_bf16"),
        "late": ("f64", "bf16_f64", "bf16_bf16"), "seg256": ("f64",),
        "pf512": ("f64",), "pf1k": ("f64",)}

# the pf variants' edit: after a producer's wait for an empty stage, the
# float64 span producers prefetch each row's next kEvery stages (128
# bytes each) into L2 every kEvery stages
_PF_AT = "    mbar_wait(&ring_empty[s], ((it / Cfg::kStages) & 1) ^ 1);\n"
_PF_BODY = """    if constexpr (kSpan && sizeof(TM) == 8) {
      constexpr int kEvery = EVERY;
      if ((c0 / C) % kEvery == 0 && c0 + kEvery * C < n) {
        const int bytes = static_cast<int>(
            min64(n - (c0 + kEvery * C), kEvery * C) * sizeof(TM));
        for (int r = threadIdx.x - 32 * kRingWarps; r < tl.rows;
             r += 32 * kRingLoaders) {
          const bool first = r < tl.split;
          if (first ? r >= real : r >= real2) continue;
          const TM* row = (first ? Mt : Mt2) + r * n + c0 + kEvery * C -
                          piece * kMPer;
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n"
                       ::"l"(row), "r"(bytes) : "memory");
        }
      }
    }
"""


def prefetch_edit(every: int) -> tuple:
    """The (text, replacement) pair of a pf variant."""
    return _PF_AT, _PF_AT + _PF_BODY.replace("EVERY", str(every))


# name -> the (text, replacement) pairs that write the variant from the
# source
VARIANTS = {
    "dfma": [("constexpr bool kSparseScatterMma = kSparseMma<TM, T> || "
              "kBf16Mma<TM, T>;",
              "constexpr bool kSparseScatterMma = kMmaForm<TM, T> || "
              "kBf16Mma<TM, T>;")],
    "ffma": [("constexpr bool kSparseScatterMma = kSparseMma<TM, T> || "
              "kBf16Mma<TM, T>;",
              "constexpr bool kSparseScatterMma = kSparseMma<TM, T>;")],
    "whole": [("    ring_run<TM, T, KC, false, true, true, true>(",
                    "    ring_run<TM, T, KC, false, true, true, false>("),
                   ("  return Ring<TM, T, KC, kMma, kMma>::kSmem;",
                    "  return Ring<TM, T, KC, false, kMma>::kSmem;")],
    "late": [("    const auto pre = store.load(tl);\n    Acc<T> acc[2][4] = {};\n"
              "    for (int64_t c0 = 0;",
              "    Acc<T> acc[2][4] = {};\n    for (int64_t c0 = 0;"),
             ("    if (active) store(acc, tl, pre);",
              "    if (active) store(acc, tl, store.load(tl));")],
    "pf512": [prefetch_edit(4)],
    "pf1k": [prefetch_edit(8)],
    "seg256": [("  static constexpr int kCols = kMma ? kMmaSegment / sizeof(TM)",
                "  static constexpr int kCols = kMma ? (sizeof(TM) == 8 ? 256 "
                ": kMmaSegment) / sizeof(TM)"),
               ("  static_assert(!kMma || kPieces == 8,",
                "  static_assert(!kMma || kPieces == 8 || sizeof(TM) == 8,"),
               ("constexpr int kRingBudget = 200 * 1024;",
                "constexpr int kRingBudget = 216 * 1024;")],
}
FORMS = ("apc", "cimmino")


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
    """One library's sparse_scatter entry (the launcher's ABI)."""

    def __init__(self, path, sfx):
        self.lib, self.sfx = ctypes.CDLL(str(path)), sfx
        self.fn = getattr(self.lib, f"sparse_scatter_{sfx}")
        self.fn.argtypes = bp.ARGTYPES["sparse_scatter"]
        self.fn.restype = ctypes.c_int

    def __call__(self, Bv, cols, U, out, X=None, Xb=None, inst="ring"):
        """``out`` with the support columns stored (APC form where X is
        given), the instance ``inst``."""
        m, w, p = Bv.shape
        k = U.shape[1]
        apc = X is not None
        err = self.fn(Bv.data_ptr(), cols.data_ptr(),
                      X.data_ptr() if apc else None,
                      Xb.data_ptr() if apc else None, U.data_ptr(), GAMMA,
                      out.data_ptr(), m, w, p, k,
                      X.stride(0) if apc else 0, X.stride(1) if apc else 0,
                      Xb.stride(0) if apc else 0, U.stride(0), U.stride(1),
                      out.stride(0), out.stride(1), bp.INSTANCES[inst], 0,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sparse_scatter_{self.sfx}: CUDA error {err}")
        return out


def ptxas_lines(log: str) -> list:
    """The sparse scatter's instances: 'sparse_scatter_ring KC=8 apc: 96
    regs, spill 0 B, smem 256 B'."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        if "entry function" in line:
            name = None
            for inst in ("_ring_kernel", "_kernel"):
                tag = f"{len('sparse_scatter') + len(inst)}sparse_scatter{inst}I"
                if tag in line:
                    rest = line.split(tag)[1]
                    kc = rest.split("Li")[1].split("E")[0]
                    form = "apc" if "Lb1E" in rest else "cimmino"
                    name = f"sparse_scatter{inst[:-7]} KC={kc} {form}"
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
    Bvals (m, w, p) on the card, the padding slots' rows zero (the
    repeated all-zero column's Bvals row, as the system's constructor
    checks)."""
    p = n // m
    band = np.zeros((m, n), bool)
    for i in range(m):
        band[i, max(i * p - bandwidth, 0):(i + 1) * p + bandwidth] = True
    cols = partition.support_cols(band)
    Bv = np.random.default_rng(seed).standard_normal((m, cols.shape[1], p))
    for i in range(m):
        _, inv, counts = np.unique(cols[i], return_inverse=True,
                                   return_counts=True)
        Bv[i][counts[inv] > 1] = 0.0
    return (torch.as_tensor(cols, device="cuda"),
            torch.as_tensor(Bv, device="cuda"))


def operands(pair, n, m, p, k, seed):
    """X (m, k, n) and U (m, k, p) as (m, k, .) views of (k, m, .)
    tensors, X̄ (k, n), seeded, in the pair's compute dtype; the APC
    form's output holds the AXPY pre-pass (ops._axpy), the Cimmino
    form's zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64,  # noqa
                               device="cuda").to(pair[1])
    X, U, Xb = r(k, m, n).transpose(0, 1), r(k, m, p).transpose(0, 1), \
        r(k, n)
    return X, Xb, U, ops._axpy(X, Xb, GAMMA), torch.zeros_like(X)


def rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1)


def calls(lib, Bv, cols, X, Xb, U, Y0, R0, fresh=True):
    """form -> f(inst) of one library's entry, on copies of the outputs
    (``fresh``) or on Y0 and R0 themselves (timed: a call stores the
    same support columns again)."""
    out = (lambda t: t.clone()) if fresh else (lambda t: t)  # noqa: E731
    return {"apc": lambda inst="ring": lib(Bv, cols, U, out(Y0), X, Xb,
                                           inst),
            "cimmino": lambda inst="ring": lib(Bv, cols, U, out(R0),
                                               inst=inst)}


def check(libs: dict) -> None:
    """``new``'s two instances of both forms in every pair against the
    plain version, ring ≡ row dot (bf16/float32: ≡ the widened ring) and a
    batch row ≡ a k = 1 call; each variant's ring against the plain
    version, the whole-tile walk's ≡ ``new``'s."""
    new = libs["new"]
    worst = {}
    for spec in SHAPES:
        cols, Bv64 = system(**spec)
        m, w, p = Bv64.shape
        for pair, sfx in bp.PAIRS.items():
            Bv = Bv64.to(pair[0])
            for k in (1, 3, 8, 11):
                X, Xb, U, Y0, R0 = operands(pair, spec["n"], m, p, k,
                                            spec["n"] + k)
                ring = bp.gather_instance(Bv, U) == "ring"
                wants = {"apc": ops.sparse_scatter_ref(Bv, cols, U, Y0, X,
                                                       Xb, GAMMA),
                         "cimmino": ops.sparse_scatter_ref(Bv, cols, U, R0)}
                run = calls(new[sfx], Bv, cols, X, Xb, U, Y0, R0)
                for form in FORMS:
                    want = wants[form]
                    got = {inst: run[form](inst) for inst in bp.INSTANCES
                           if inst == "row_dot" or ring}
                    torch.cuda.synchronize()
                    for inst, y in got.items():
                        e = rel(y, want)
                        assert y.dtype == pair[1] and e < TOL[pair[1]], (
                            form, sfx, inst, spec, k, e)
                        worst[(form, sfx)] = max(worst.get((form, sfx), 0.0),
                                                 e)
                        row = calls(new[sfx], Bv, cols, X[:, k - 1:],
                                    Xb[k - 1:], U[:, k - 1:], Y0[:, k - 1:],
                                    R0[:, k - 1:])[form](inst)
                        assert torch.equal(row, y[:, k - 1:]), (
                            form, sfx, inst, spec, k)
                    if ring and sfx == "bf16_f32":
                        wide = calls(new["f32"], Bv.float(), cols, X, Xb, U,
                                     Y0, R0)[form]()
                        assert torch.equal(got["ring"], wide), (form, spec,
                                                                k)
                    elif ring:
                        assert torch.equal(got["ring"], got["row_dot"]), (
                            form, sfx, spec, k)
                    for name, lib in libs.items():
                        if name in ("new", "baseline") or sfx not in lib \
                                or not ring:
                            continue
                        y = calls(lib[sfx], Bv, cols, X, Xb, U, Y0,
                                  R0)[form]()
                        e = rel(y, want)
                        assert e < TOL[pair[1]], (name, form, sfx, spec, k, e)
                        if name in ("whole", "late", "seg256", "pf512",
                                    "pf1k"):
                            assert torch.equal(y, got["ring"]), (
                                name, form, sfx, spec, k)
                        worst[(name, form, sfx)] = max(
                            worst.get((name, form, sfx), 0.0), e)
    for key, e in worst.items():
        same = ("ring ≡ widened ring" if key[-1] == "bf16_f32"
                else "ring ≡ row dot")
        print(f"probe check {' '.join(key)}: plain max rel {e:.3e}"
              + (f"; {same}; batch row ≡ k = 1 call" if len(key) == 2
                 else "")
              + ("; ≡ new ring" if key[0] in (
                  "whole", "late", "seg256", "pf512", "pf1k") else ""),
              flush=True)


def walk_rows(rows, units, sms, span):
    """(rows, tiles) each block streams in the tensor-core walk of
    ``units`` (worker, k-chunk) units of ``rows`` rows on min(sms, units ·
    ceil(rows / 256)) blocks: csrc SpanWalk (``span``: 16-row groups
    evenly, a tile at most 16 groups over at most two units) or MmaWalk
    (equal counts of whole tiles, each within a unit)."""
    per_t = -(-rows // 256)
    grid = min(sms, units * per_t)
    out = []
    for b in range(grid):
        if span:
            per = -(-rows // 16)
            total = units * per
            g, end = total * b // grid, total * (b + 1) // grid
            n, tiles = 0, 0
            while g < end:
                stop = min(end, g + 16, (g // per + 2) * per)
                n, tiles, g = n + 16 * (stop - g), tiles + 1, stop
        else:
            tiles_all = units * per_t
            t0, t1 = tiles_all * b // grid, tiles_all * (b + 1) // grid
            n = sum(min(256, rows - t % per_t * 256) for t in range(t0, t1))
            tiles = t1 - t0
        out.append((n, tiles))
    return out


def times(libs: dict, reps: int) -> None:
    """CUDA-event medians (ms a call; eager runs of 10 calls and the
    replay of 10 captured ones) at the sparse path's shapes, k = 1 and 8,
    the libraries in turns."""
    order = list(libs) + list(libs)[::-1]
    cols, Bv64 = system(**SPARSE)
    m, w, p = Bv64.shape
    n = SPARSE["n"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in (1, 8):
        kc = 8 if k > 1 else 1
        for span in (True, False):
            r = walk_rows(w, m * -(-k // kc), sms, span)
            nr = [x[0] for x in r]
            print(f"probe walk k={k} {'span' if span else 'whole'}: "
                  f"{len(r)} blocks, slowest {max(nr)} rows, mean "
                  f"{sum(nr) / len(nr):.1f}, "
                  f"{max(nr) * len(nr) / sum(nr):.3f}x; "
                  f"at most {max(x[1] for x in r)} tiles a block",
                  flush=True)
        timed_calls, bounds = {}, {}
        for pair, sfx in bp.PAIRS.items():
            Bv = Bv64.to(pair[0])
            X, Xb, U, Y0, R0 = operands(pair, n, m, p, k, seed=k)
            xs = pair[1].itemsize
            mkw, mkp = m * k * w, m * k * p
            for form in FORMS:
                for name in libs:
                    if sfx not in libs[name]:
                        continue
                    run = calls(libs[name][sfx], Bv, cols, X, Xb, U, Y0, R0,
                                fresh=False)
                    for inst in ("ring", "row_dot") if k == 1 else ("ring",):
                        timed_calls[(name, sfx, form, inst)] = (
                            lambda f=run[form], i=inst: f(i))
                bounds[(sfx, form)] = (
                    pair[0].itemsize * m * w * p + 8 * m * w
                    + xs * (mkp + (3 if form == "apc" else 1) * mkw)
                ) / HBM * 1e3
                if pair[0] == pair[1]:
                    timed_calls[("torch", sfx, form, "bmm")] = (
                        lambda U=U, Bv=Bv: torch.bmm(U, Bv.transpose(1, 2)))
        samples = {key: [] for key in timed_calls}
        for fn in timed_calls.values():             # warm every call
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
        for key, fn in timed_calls.items():         # 10 calls a graph
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(10):
                    fn()
            graphs[key] = graph.replay
            torch.cuda.synchronize()
        gsamples = {key: [] for key in timed_calls}
        for _ in range(reps):
            for name in order + ["torch"]:
                for key, fn in timed_calls.items():
                    if key[0] == name:
                        samples[key].append(timed(fn))
                        gsamples[key].append(timed(graphs[key], 1))
        for key in sorted(samples, key=lambda key: (key[2], key[1], key[0],
                                                    key[3])):
            name, sfx, form, inst = key
            ms = float(np.median(samples[key]))
            gms = float(np.median(gsamples[key]))
            b = bounds[(sfx, form)]
            what = ("torch.bmm (U·Bvalsᵀ, no scatter)" if name == "torch"
                    else f"{name} {inst}")
            print(f"probe time m={m} p={p} w={w} n={n} k={k} {sfx} {form} "
                  f"{what}: graph {gms:.4f} ms ({b / gms:.1%} of bound "
                  f"{b:.4f} ms); eager {ms:.4f} ms", flush=True)
        del timed_calls, graphs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="another checkout's root: its libraries built and "
                    "timed beside these")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sparse_scatter: no CUDA device", file=sys.stderr)
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
        libs.setdefault(name, {})[sfx] = Lib(path, sfx)
        if name == "new":
            lib = libs[name][sfx].lib
            lib.gather_ring_smem.argtypes = bp.RING_SMEM_ARGTYPES
            lib.gather_ring_smem.restype = ctypes.c_int64
            pair = next(pr for pr, s in bp.PAIRS.items() if s == sfx)
            smem = [lib.gather_ring_smem(pair[0].itemsize,
                                         pair[1].itemsize, k,
                                         bp.FORMS["sparse_scatter"])
                    for k in (1, 8)]
            print(f"probe smem new {sfx}: k=1 {smem[0]} B, k=8 "
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
