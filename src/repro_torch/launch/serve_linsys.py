"""Linear-system serving driver of the port: a request stream through
``LinsysServer`` (counterpart of ``repro.launch.serve_linsys``).

Generates a handful of synthetic systems on the card (or ``--device
cpu``), registers them with the server (content-addressed fingerprints),
submits a seeded FIFO stream of (fingerprint, rhs) requests, and drains
it batch by batch — same-system requests coalesce into ``solve_many``
groups, every factorization comes from the ``FactorStore`` (persist it
across runs with ``--store-dir``), and each batch replays the executor's
captured program.  Throughput excludes padding; times are the host's
clock around work that ends on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve_linsys --requests 12 \
        --systems 2 --batch 4 --solver apc --iters 400 --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve_linsys \
        --store-dir /tmp/factors --warm-start

``--async`` swaps in the pipelined ``AsyncLinsysServer``: requests are
submitted on an open-loop Poisson schedule (``--arrival-rate`` req/s; 0 =
all at t=0) and served by the overlapped admission/assembly/execution
stages (``--pipeline-depth`` in-flight batches, ``--admit-capacity``
bounds queued+in-flight requests — overflow is shed with an explicit
result).  The run ends with the SLO latency report (p50/p95/p99).

    PYTHONPATH=src python -m repro_torch.launch.serve_linsys --async \
        --requests 24 --arrival-rate 50 --pipeline-depth 2

``--backend mesh`` serves on the ``torch.distributed`` mesh backend, one
rank a process: alone, a one-rank group (``launch/mesh.init_group``);
under ``torchrun``, the ranks it starts.  Every rank makes and registers
the same systems; rank 0 admits the stream, announces each batch to the
others (``LinsysServer.serve_follower``) and prints, and ends the
followers when it is done.

    PYTHONPATH=src torchrun --nproc-per-node 2 -m \
        repro_torch.launch.serve_linsys --backend mesh --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.data import linsys
from repro_torch.launch import mesh as mesh_lib
from repro_torch.solvers.capability import ExecutionPlan
from repro_torch.solvers.pipeline import AsyncLinsysServer, Shed
from repro_torch.solvers.serve import LinsysServer
from repro_torch.solvers.store import FactorStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="apc", choices=solvers.available())
    ap.add_argument("--backend", default="local", choices=["local", "mesh"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--systems", type=int, default=2,
                    help="distinct linear systems sharing the serve loop")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--cond", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store-dir", default=None,
                    help="disk tier for the factor store (factorizations "
                         "survive restarts; re-run to see disk hits)")
    ap.add_argument("--store-capacity", type=int, default=8)
    ap.add_argument("--warm-start", action="store_true",
                    help="reuse a system's prior batch state for repeated "
                         "(any solver) or perturbed (gradient family / "
                         "Cimmino) right-hand sides")
    ap.add_argument("--use-kernel", action="store_true",
                    help="serve batches through the CUDA kernels "
                         "(projection solvers)")
    ap.add_argument("--x64", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="serve through the pipelined AsyncLinsysServer "
                         "(overlapped admission/assembly/execution)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s for "
                         "--async (0 = submit everything at t=0)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="concurrently-executing batches in --async mode")
    ap.add_argument("--admit-capacity", type=int, default=None,
                    help="admission bound (queued + in flight) in --async "
                         "mode; overflow requests are shed explicitly")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device, say = dev.resolve(args.device), print
    if args.backend == "mesh":
        # the group first: under torchrun it decides this rank's device
        device = mesh_lib.init_group(device)
        if dist.get_rank() != 0:
            say = lambda *a, **k: None      # noqa: E731 (rank 0 prints)
    dtype = torch.float64 if args.x64 else torch.float32
    store = FactorStore(capacity=args.store_capacity,
                        directory=args.store_dir)
    plan = ExecutionPlan(backend=args.backend, kernel=args.use_kernel)
    kw = dict(solver=args.solver, iters=args.iters, tol=args.tol,
              batch=args.batch, plan=plan, warm_start=args.warm_start)
    if args.async_:
        srv = AsyncLinsysServer(store, pipeline_depth=args.pipeline_depth,
                                admit_capacity=args.admit_capacity, **kw)
    else:
        srv = LinsysServer(store, **kw)

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    rng = np.random.default_rng(args.seed)
    fps, systems = [], []
    for i in range(args.systems):
        sys_ = linsys.conditioned_gaussian(n=args.n, m=args.workers,
                                           cond=args.cond, seed=args.seed + i,
                                           dtype=dtype, device=device)
        fp = srv.register(sys_)
        fps.append(fp)
        systems.append(sys_)
        say(f"registered system {i}: N={sys_.N} n={sys_.n} m={sys_.m} "
            f"fingerprint {fp[:16]}...")
    if args.backend == "mesh":
        say(f"mesh backend over {dist.get_world_size()} rank(s), "
            f"{dist.get_backend()}: rank 0 admits")
        if dist.get_rank() != 0:
            srv.serve_follower()
            return 0
    try:
        return _serve(args, srv, store, fps, systems, rng, where)
    finally:
        srv.close()             # on a mesh of several ranks: their stop


def _serve(args, srv, store, fps, systems, rng, where) -> int:
    """Rank 0's (or the one process's) request stream and its report."""
    picks = [int(rng.integers(0, args.systems))
             for _ in range(args.requests)]
    rhss = [rng.standard_normal(systems[i].N) for i in picks]

    n_bad = 0
    if args.async_:
        # open-loop Poisson arrivals: submission times never wait on
        # completions, so saturation shows up as queueing/shedding
        if args.arrival_rate > 0:
            arr = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                            size=args.requests))
        else:
            arr = np.zeros(args.requests)
        t0 = time.time()
        with srv:
            tickets = []
            for i in range(args.requests):
                wait = t0 + arr[i] - time.time()
                if wait > 0:
                    time.sleep(wait)
                tickets.append(srv.submit(fps[picks[i]], rhss[i]))
            results = [t.result() for t in tickets]
        dt = time.time() - t0
        n_shed = 0
        for r in results:
            if isinstance(r, Shed):
                n_shed += 1
                continue
            n_bad += r.residual >= args.tol
        rep = srv.latency_report()
        print(f"async pipeline (depth {srv.pipeline_depth}, capacity "
              f"{srv.admit_capacity}): {srv.stats.served} served / "
              f"{n_shed} shed over {srv.stats.batches} batches")
        print(f"latency p50/p95/p99 {rep['p50_ms']:.0f}/{rep['p95_ms']:.0f}"
              f"/{rep['p99_ms']:.0f} ms  mean {rep['mean_ms']:.0f} ms")
    else:
        for i in range(args.requests):
            srv.submit(fps[picks[i]], rhss[i])
        t0 = time.time()
        while True:
            tb = time.time()
            batch = srv.step()
            if not batch:
                break
            bt = time.time() - tb
            worst = max(r.residual for r in batch)
            n_bad += sum(r.residual >= args.tol for r in batch)
            print(f"batch {srv.stats.batches}: {len(batch)} request(s) "
                  f"[{batch[0].fp[:8]}...] in {bt * 1e3:7.1f} ms  "
                  f"worst residual {worst:.2e}"
                  + ("  (warm)" if batch[0].warm else ""))
        dt = time.time() - t0

    st = srv.stats
    print(f"served {st.served} requests in {dt:.2f}s on {where} "
          f"({st.served / dt:.1f} RHS/s, padding excluded: "
          f"{st.padded} pad slot(s) over {st.batches} batches)")
    print(f"factor store: {store.stats}")
    print(f"executors built: {st.executor_builds}  "
          f"jit cache entries: {srv.jit_cache_size()}  "
          f"warm batches: {st.warm_batches}")
    if n_bad:
        print(f"WARNING: {n_bad} request(s) above tol={args.tol:.0e} — "
              f"raise --iters")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
