#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one stdout line (or a few) each; any failure raises and the
script exits non-zero without its last line:

1. environment: versions, the card's name and power limit, TF32 off, and
   the CUDA kernels built from the checkout's sources;
2. kernel vs plain version on the card: ``apc_gather``/``apc_scatter``
   against their plain PyTorch versions at ragged shapes and at the main
   path's shapes, float64 and float32;
3. the main path at full size: a 32768 x 16384 tall Gaussian system on
   16 workers (float64), ``analyze``, then ``solve`` on the kernel path —
   error to x_true, one launch of each kernel per iteration, the history
   against the unfused path, and a bit-identical repeat;
4. ``solve_many`` with 8 right-hand sides through the same kernels;
5. the CLI entry point ``repro_torch.launch.solve`` in-process;
6. CUDA-event times of each kernel, its plain version, one torch.matmul
   of the same product and the whole iteration, beside each kernel's
   bound, printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Imports only torch,
numpy and repro_torch.
"""
from __future__ import annotations

import json
import pathlib
import re
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
# kernel vs plain: max|Δ| / (max|plain| + 1), tests/test_kernels.py TOL
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
RAGGED = [(7, 130), (1, 128), (24, 896)]
# (HBM bytes/s, float64 and float32 peak op/s) from NVIDIA's data sheets,
# matched on the name nvidia-smi reports; the first match wins
CARDS = [("H100 PCIe", 2.0e12, 51e12, 51e12),
         ("H100 NVL", 3.9e12, 60e12, 60e12),
         ("H200", 4.8e12, 67e12, 67e12),
         ("H100", 3.35e12, 67e12, 67e12)]
SOURCE = "src/repro_torch/kernels/csrc/block_projection.cu"
REPLACES = {"apc_gather": "src/repro/kernels/block_projection.py:173",
            "apc_scatter": "src/repro/kernels/block_projection.py:210"}


def say(*parts) -> None:
    print(*parts, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, bw, f64, f32 in CARDS:
        if key in name:
            return bw, {torch.float64: f64, torch.float32: f32}
    raise RuntimeError(f"no bandwidth/peak entry for card {name!r}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|Δ| / (max|want| + 1), max|Δ|)"""
    d = float((got.double() - want.double()).abs().max())
    return d / (float(want.double().abs().max()) + 1.0), d


def ptxas_summary(log: str) -> list[str]:
    """'apc_gather f64 KC=8 spill 0 B: 168 regs' per kernel instance,
    from nvcc's -Xptxas=-v output."""
    out, kernel = [], None
    for line in log.splitlines():
        hit = re.search(r"entry function '\S*?(apc_\w+?)_kernelI([df])Li(\d+)",
                        line)
        if hit:
            kernel = (f"{hit[1]} {'f64' if hit[2] == 'd' else 'f32'} "
                      f"KC={hit[3]}")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and spill:
            kernel += f" spill {spill[1]} B"
        regs = re.search(r"Used (\d+) registers", line)
        if kernel and regs:
            out.append(f"{kernel}: {regs[1]} regs")
            kernel = None
    return out


def median_ms(fn, reps: int = 25) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def inputs(m, p, n, k, dtype, seed, *, transposed=False):
    """Seeded A (m,p,n), B (m,n,p), X (m,k,n), X̄ (k,n) on the card.

    ``transposed`` gives X as the (m, k, n) view of a (k, m, n) tensor,
    the layout solve_many hands the kernels."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                   device="cuda").to(dtype)
    A, B = g(m, p, n), g(m, n, p)
    X = g(k, m, n).transpose(0, 1) if transposed else g(m, k, n)
    return A, B, X, g(k, n)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import solvers
    from repro_torch.core.apc import APCState
    from repro_torch.core.partition import BlockSystem
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli

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
    say("phase 1 ptxas: " + "; ".join(ptxas_summary(
        lib.with_suffix(".log").read_text())))

    # 2. kernel vs plain version ------------------------------------------
    max_abs = dict.fromkeys(bp.KERNELS, 0.0)

    def compare(A, B, X, Xb, gamma, label, record=False):
        dt = A.dtype
        u = ops.proj_gather(A, X, Xb)
        u_ref = ops.apc_gather_ref(A, X, Xb)
        y = ops.proj_scatter(B, X, Xb, u_ref, gamma)
        y_ref = ops.apc_scatter_ref(B, X, Xb, u_ref, gamma)
        torch.cuda.synchronize()
        (eu, du), (ey, dy) = rel_err(u, u_ref), rel_err(y, y_ref)
        say(f"phase 2 {label} {str(dt)[6:]}: apc_gather {eu:.3e} "
            f"apc_scatter {ey:.3e} (tol {TOL[dt]:.0e})")
        assert eu < TOL[dt] and ey < TOL[dt], (label, dt, eu, ey)
        if X.dim() == 3:    # a batch row is bit-identical to a k=1 call
            i = X.shape[1] - 1
            assert torch.equal(ops.proj_gather(A, X[:, i], Xb[i]), u[:, i])
            assert torch.equal(ops.proj_scatter(B, X[:, i], Xb[i],
                                                u_ref[:, i], gamma),
                               y[:, i])
        if record:
            max_abs["apc_gather"] = max(max_abs["apc_gather"], du)
            max_abs["apc_scatter"] = max(max_abs["apc_scatter"], dy)

    for dt in TOL:
        for (p, n) in RAGGED:
            for k in (1, 5, 11):
                compare(*inputs(3, p, n, k, dt, seed=p * n + k,
                                transposed=k > 1), 0.83,
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
        for dt in TOL:
            A, B = factors.A.to(dt), factors.B.to(dt)
            Xd, Xbd = X.to(dt).transpose(0, 1), Xb.to(dt)
            if k == 1:
                Xd, Xbd = Xd[:, 0], Xbd[0]
            compare(A, B, Xd, Xbd, 0.9, f"main path m={m} p={p} n={n} "
                    f"k={k}", record=dt == torch.float64)
            del A, B

    # 3. the main path at full size ---------------------------------------
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
    launches = ops.launch_counts()
    err = float(torch.linalg.norm(res.x - sys_.x_true)
                / torch.linalg.norm(sys_.x_true))
    say(f"phase 3 solve kernel=True: {ITERS} iters in {t_solve:.2f} s "
        f"(prepare included), residual {float(res.residuals[-1]):.3e} "
        f"rel-error {err:.3e} iters_to_tol {res.iters_to_tol} "
        f"launches {launches}")
    assert err <= 1e-8, err
    assert launches == dict.fromkeys(bp.KERNELS, ITERS), launches
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
    xs = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (K_MANY, n)), device="cuda")
    Bm = (sys_.A_blocks.reshape(sys_.N, n) @ xs.T).T      # (k, N)
    ops.reset_launch_counts()
    t = time.time()
    many = solver.solve_many(sys_, Bm, iters=ITERS, plan=kplan, **params)
    torch.cuda.synchronize()
    t_many = time.time() - t
    launches_many = ops.launch_counts()
    assert launches_many == dict.fromkeys(bp.KERNELS, ITERS), launches_many
    worst = 0.0
    for i in range(K_MANY):
        row = BlockSystem(sys_.A_blocks, Bm[i].reshape(m, p), xs[i],
                          mode="square")
        one = solver.solve(row, iters=ITERS, plan=solvers.ExecutionPlan(
            kernel=True, factors=factors), **params)
        d = float(torch.linalg.norm(many.x[i] - one.x)
                  / torch.linalg.norm(one.x))
        worst = max(worst, d)
        assert d <= 1e-10, (i, d)
        assert float(torch.linalg.norm(many.x[i] - xs[i])
                     / torch.linalg.norm(xs[i])) <= 1e-8
    say(f"phase 4 solve_many k={K_MANY}: {ITERS} iters in {t_many:.2f} s, "
        f"launches {launches_many}, max row vs single solve {worst:.3e}")

    # 5. the CLI entry point ----------------------------------------------
    ops.reset_launch_counts()
    rc = cli.main(CLI_ARGS)
    assert rc == 0, rc
    launches_cli = ops.launch_counts()
    assert all(v > 0 for v in launches_cli.values()), launches_cli
    say(f"phase 5 cli {' '.join(CLI_ARGS)}: rc {rc} launches "
        f"{launches_cli}")

    # 6. times --------------------------------------------------------------
    rows = {}
    itemsize = 8
    b = sys_.b_blocks
    for k in (1, K_MANY):
        rng = np.random.default_rng(3 + k)
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        X3 = X.transpose(0, 1)                       # (m, k, n) view
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        A, B = factors.A, factors.B
        U = bp.apc_gather(A, X3, Xb)
        D = Xb - X3
        g_bytes = itemsize * (m * p * n + m * k * n + k * n + m * k * p)
        s_bytes = itemsize * (m * n * p + 2 * m * k * n + k * n + m * k * p)
        g_ops = 2 * m * k * p * n + m * k * n
        s_ops = 2 * m * k * p * n + 4 * m * k * n
        t_g = median_ms(lambda: bp.apc_gather(A, X3, Xb))
        t_gp = median_ms(lambda: ops.apc_gather_ref(A, X3, Xb))
        t_gl = median_ms(lambda: torch.matmul(D, A.transpose(1, 2)))
        t_s = median_ms(lambda: bp.apc_scatter(B, X3, Xb, U, 0.9))
        t_sp = median_ms(lambda: ops.apc_scatter_ref(B, X3, Xb, U, 0.9))
        t_sl = median_ms(lambda: torch.matmul(U, B.transpose(1, 2)))
        if k == 1:
            st = APCState(x=X[0], xbar=Xb[0], t=0)
            t_it = median_ms(lambda: solver.step_residual(
                factors, b, st, params))
        else:
            st = APCState(x=X, xbar=Xb, t=0)
            bb = b.expand(k, m, p)
            t_it = median_ms(lambda: solver.step_many_residual(
                factors, bb, st, params))
        for kname, t_k, t_p, t_l, nbytes, nops in (
                ("apc_gather", t_g, t_gp, t_gl, g_bytes, g_ops),
                ("apc_scatter", t_s, t_sp, t_sl, s_bytes, s_ops)):
            t_bytes = nbytes / bw * 1e3
            t_ops = nops / peak[torch.float64] * 1e3
            rows[(kname, k)] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            r = rows[(kname, k)]
            say(f"phase 6 {kname} k={k} m={m} p={p} n={n} float64: "
                f"{t_k:.4f} ms (bound {r['bound_ms']:.4f} ms by "
                f"{r['bound_by']}, {r['bound_ms'] / t_k:.1%} of it), plain "
                f"{t_p:.4f} ms, torch.matmul {t_l:.4f} ms")
        say(f"phase 6 iteration k={k}: {t_it:.4f} ms per step "
            f"(gather + scatter + master update + residual)")
        del U, D

    kernels = []
    for kname in bp.KERNELS:
        r = rows[(kname, 1)]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max_abs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": kernels}))
    say(f"total {time.time() - t0:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
