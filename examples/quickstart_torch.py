"""Quickstart on the PyTorch port: solve a distributed linear system with
APC and compare every method from the paper — all through the unified
solver registry (twin of examples/quickstart.py):

    from repro_torch import solvers
    result = solvers.get("apc").solve(sys_, iters=3000)
    print(solvers.available())   # all eight methods, one call path

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Everything runs on the card unless ``--device cpu``.  Before sending a
change, ``bash scripts/ci_torch.sh`` runs the port's contract checks
(``python -m repro_torch.analysis``), its tests and its smokes.
"""
import argparse
import time

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.core import spectral
from repro_torch.data import linsys


def _np(t):
    return t.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    device = dev.resolve(ap.parse_args(argv).device)

    # A 500x500 system with controlled conditioning, split across m=4
    # workers (the paper's exact Table-2 ensembles need 10^4-10^5
    # iterations by design; this kappa shows every method's behaviour in
    # 3000 iterations).
    sys_ = linsys.conditioned_gaussian(n=500, m=4, cond=300.0, seed=0,
                                       device=device)
    print(f"system: N={sys_.N} n={sys_.n} workers={sys_.m} "
          f"(p={sys_.p} rows each) on {device}")

    # Taskmaster-side analysis: optimal rates per method (Theorem 1 / Sec 4).
    s = spectral.rates_summary(sys_)
    print(f"kappa(X) = {s['kappa_X']:.3e}   kappa(A^T A) = {s['kappa_AtA']:.3e}")
    print("optimal rates:", {k: round(v, 6) for k, v in s.items()
                             if k not in ("mu_min", "mu_max", "kappa_X",
                                          "kappa_AtA")})

    # Every method from the paper through the identical registry call path.
    iters = 3000
    for name in ["apc", "dhbm", "dnag", "cimmino", "dgd", "pdhbm"]:
        solver = solvers.get(name)
        res = solver.solve(sys_, iters=iters)
        reached = (f"residual<{res.tol:.0e} @ iter {res.iters_to_tol}"
                   if res.iters_to_tol != -1 else "tolerance not reached")
        print(f"{solver.paper_name:10s} after {iters} iters: rel-error "
              f"{float(res.errors[-1]):.3e}   ({reached})")

    # The serving hot path: one factorization, a batch of right-hand sides.
    B = np.random.default_rng(1).standard_normal((4, sys_.N))
    batch = solvers.get("apc").solve_many(sys_, B, iters=1000)
    print(f"solve_many: 4 RHS, final residuals "
          f"{[f'{float(r[-1]):.1e}' for r in batch.residuals]}")

    # Execution options travel on ONE object: solvers.ExecutionPlan
    # (backend/mesh, kernel, precision, redundancy/alive_schedule, store,
    # warm_state...).  kernel=True routes the projection family
    # (apc/consensus/cimmino) through the hand-written CUDA kernels on the
    # card (their plain PyTorch versions on the CPU) — single or batched
    # RHS, local or mesh backend; histories match the unfused path to
    # <= 1e-6.
    rk = solvers.get("apc").solve_many(
        sys_, B, iters=1000, plan=solvers.ExecutionPlan(kernel=True))
    print(f"solve_many(plan=ExecutionPlan(kernel=True)): max |Δresidual| "
          f"vs unfused "
          f"{float((rk.residuals - batch.residuals).abs().max()):.1e}")
    from repro_torch.launch.mesh import solver_mesh
    rkm = solvers.get("apc").solve(
        sys_, iters=1000,
        plan=solvers.ExecutionPlan(kernel=True, backend="mesh",
                                   mesh=solver_mesh(1, 1, device=device)))
    print(f"mesh + use_kernel: rel-error {float(rkm.errors[-1]):.3e} "
          f"(each rank runs the kernels on its shard, all_reduce contract "
          f"unchanged)")
    import torch.distributed as dist
    dist.destroy_process_group()             # the one-rank mesh's group

    # Cached factorizations: a FactorStore content-addresses the one-time
    # b-independent prepare, and LinsysServer serves a request stream from
    # it with a compile-once executor — the first batch is COLD (prepare +
    # capture, a store miss), every later one WARM (a store hit, a replay).
    serve_sys = linsys.conditioned_gaussian(n=256, m=4, cond=20.0, seed=2,
                                            device=device)
    store = solvers.FactorStore()
    srv = solvers.LinsysServer(store, solver="apc", iters=300, batch=4,
                               plan=solvers.ExecutionPlan(kernel=True))
    fp = srv.register(serve_sys)             # content fingerprint
    rng = np.random.default_rng(2)
    for tag in ("cold", "warm", "warm"):
        for _ in range(4):
            srv.submit(fp, rng.standard_normal(serve_sys.N))
        t0 = time.perf_counter()
        served = srv.step()
        dt = time.perf_counter() - t0
        print(f"factor store, {tag} batch: 4 RHS in {dt * 1e3:7.1f} ms  "
              f"(worst residual {max(r.residual for r in served):.1e})")
    print(f"store {store.stats}  (entry kernel-augmented once)")

    # System modes: the same call path covers sparse, overdetermined
    # least-squares and streaming systems; each solver declares its
    # capabilities, checked at dispatch (pdhbm on a sparse system raises
    # solvers.CapabilityError).
    sp = linsys.banded_system(n=256, m=4, bandwidth=8, seed=3, device=device)
    rs = solvers.get("apc").solve(sp, iters=400)
    rd = solvers.get("apc").solve(sp.densified(), iters=400)
    print(f"sparse: banded n={sp.n} ({sp.sparsity:.0%} zero)  rel-error "
          f"{float(rs.errors[-1]):.3e}  |dx| vs densified "
          f"{float((rs.x - rd.x).abs().max()):.1e}")

    # Sparse systems are kernel-first too: kernel=True runs the
    # compressed-support kernels (gather the w support columns, contract
    # the (p, w) vals / (w, p) compressed-pinv tiles, store back).
    # precision="mixed" keeps the matrices in bf16 under float64 x.
    rsk = solvers.get("apc").solve(
        sp, iters=400, plan=solvers.ExecutionPlan(kernel=True))
    print(f"sparse + kernel: max |Δresidual| vs unfused "
          f"{float((rsk.residuals - rs.residuals).abs().max()):.1e}")
    rsm = solvers.get("apc").solve(
        sp, iters=400,
        plan=solvers.ExecutionPlan(kernel=True, precision="mixed"))
    print(f"sparse + use_kernel + precision='mixed': final residual "
          f"{float(rsm.residuals[-1]):.1e} (bf16 matrices)")

    ls = linsys.tall_gaussian(N=320, n=160, m=4, seed=3, noise=0.05,
                              device=device)
    rl = solvers.get("dgd").solve(ls, iters=800)
    A_ls, b_ls = (_np(t) for t in ls.dense())
    ref = np.linalg.lstsq(A_ls, b_ls, rcond=None)[0]
    rel = float(np.linalg.norm(_np(rl.x) - ref) / np.linalg.norm(ref))
    print(f"least-squares: N={ls.N} > n={ls.n} (inconsistent)  "
          f"rel-error vs lstsq {rel:.1e}")

    # Streaming: solve_stream drives a server through perturbed right-hand
    # sides; warm-start solvers (gradient family + cimmino) seed each
    # solve from the previous answer.
    st_sys = linsys.conditioned_gaussian(n=192, m=4, cond=20.0, seed=4,
                                         device=device)
    ssrv = solvers.LinsysServer(store, solver="dhbm", iters=300, batch=1,
                                warm_start=True)
    sfp = ssrv.register(st_sys)
    b0 = _np(st_sys.dense()[1])
    stream = [(sfp, b0 + 1e-3 * rng.standard_normal(st_sys.N))
              for _ in range(8)]
    srep = solvers.solve_stream(ssrv, stream)
    print(f"stream: {len(srep.served)} perturbed-b requests  "
          f"warm hit rate {srep.warm_hit_rate:.0%}")

    # Async pipelined serving: bounded admission (a full pipeline SHEDS
    # with an explicit result), batch assembly on a host thread, up to
    # pipeline_depth batches in flight, per-request tickets.
    asrv = solvers.AsyncLinsysServer(store, solver="apc", iters=300,
                                     batch=4, pipeline_depth=2,
                                     admit_capacity=64,
                                     plan=solvers.ExecutionPlan(kernel=True))
    afp = asrv.register(serve_sys)
    with asrv:                               # start()/close() the stages
        tickets = [asrv.submit(afp, rng.standard_normal(serve_sys.N))
                   for _ in range(8)]
        results = [t.result() for t in tickets]
    rep = asrv.latency_report()
    shed = sum(isinstance(r, solvers.Shed) for r in results)
    print(f"async pipeline: {asrv.stats.served} served / {shed} shed, "
          f"p50/p99 {rep['p50_ms']:.0f}/{rep['p99_ms']:.0f} ms, "
          f"worst residual "
          f"{max(r.residual for r in results if not isinstance(r, solvers.Shed)):.1e}")

    # Elastic fleets: with redundancy r, a permanent worker death
    # re-lowers the selection weights over the survivors — the iterate
    # continues EXACTLY, zero iterations lost.
    from repro_torch.runtime.fault import HeartbeatMonitor
    el_sys = linsys.conditioned_gaussian(n=128, m=4, cond=10.0, seed=5,
                                         device=device)
    mon = HeartbeatMonitor(n_workers=el_sys.m)
    rt = solvers.ElasticRuntime(solvers.get("apc"), el_sys,
                                plan=solvers.ExecutionPlan(redundancy=2),
                                monitor=mon, segment=25)
    rt.run(iters=50)
    mon.mark_dead(2)                         # permanent loss mid-solve
    rep_el = rt.run(iters=100)
    oracle = solvers.get("apc").solve(el_sys, iters=150)
    survivors = sorted(set(rep_el.fleet) - mon.dead)
    print(f"elastic: worker 2 died @50, re-lowered over survivors "
          f"{survivors}; final residual "
          f"{float(rep_el.result.residuals[-1]):.1e} "
          f"(== full-fleet oracle {float(oracle.residuals[-1]):.1e}, "
          f"0 iterations lost)")


if __name__ == "__main__":
    main()
