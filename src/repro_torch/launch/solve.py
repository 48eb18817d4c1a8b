"""Distributed solve driver of the port (local subset of
``repro.launch.solve``).

Partitions a linear system (any ``--problem`` of the reference: dense,
least-squares ``tall_noisy``, or sparse, whose structure survives the
re-partition) across workers, runs any registered solver (``--method``,
APC by default) with its auto-tuned optimal parameters on the card (or
``--device cpu``), and prints the same lines as the reference's CLI.
``--use-kernel`` routes the worker update of apc, consensus and cimmino
through the hand-written CUDA kernels (the sparse ones on a sparse
problem); the other solvers have no kernel: on a sparse problem they
warn and run the unfused sparse path, on a dense one they raise, as the
library's ``resolve_plan`` decides.  The mesh
backend, redundancy, checkpoints and the factor store are not offered
yet (ROADMAP A12, A14, A15).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.solve --problem ash608 \
        --workers 4 --iters 200 --use-kernel
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.core import spectral
from repro_torch.core.partition import as_sparse, pad_to_blocks, partition
from repro_torch.data import linsys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="std_gaussian",
                    choices=sorted(linsys.ALL_PROBLEMS))
    ap.add_argument("--method", default="apc", choices=solvers.available(),
                    help="registered solver")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the per-worker update through the CUDA "
                         "kernels: apc_gather/apc_scatter for apc and "
                         "consensus, cimmino_gather/cimmino_scatter for "
                         "cimmino (no other method has a kernel: on a "
                         "sparse problem it warns and runs unfused)")
    ap.add_argument("--x64", action=argparse.BooleanOptionalAction,
                    default=True, help="float64 math (default on)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    solver = solvers.get(args.method)

    device = dev.resolve(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    sys_ = linsys.ALL_PROBLEMS[args.problem](seed=args.seed, dtype=dtype,
                                             device=device)
    # re-partition to the requested worker count, preserving the system's
    # mode (least-squares stays least-squares) and sparse structure
    was_sparse = sys_.is_sparse
    A, b = pad_to_blocks(*sys_.dense(), args.workers)
    sys_ = partition(A, b, args.workers, x_true=sys_.x_true, mode=sys_.mode)
    if was_sparse:
        sys_ = as_sparse(sys_)

    params, rho = solver.analyze(sys_)   # one spectral pass for both
    print(f"problem {args.problem}: N={sys_.N} n={sys_.n} m={sys_.m}  "
          f"method={args.method}")
    print(f"optimal params {({k: round(v, 4) for k, v in params.items()})}"
          + (f"  rho={rho:.6f} "
             f"(T={spectral.convergence_time(rho):.1f} iters/decade)"
             if rho is not None else ""))

    t0 = time.time()
    plan = solvers.ExecutionPlan(kernel=args.use_kernel)
    res = solver.solve(sys_, iters=args.iters, plan=plan, **params)
    final_res = float(res.residuals[-1])
    if res.iters_to_tol != -1:
        print(f"reached residual < {res.tol:.0e} after "
              f"{res.iters_to_tol} iters")
    err = (float(torch.linalg.norm(res.x - sys_.x_true)
                 / torch.linalg.norm(sys_.x_true))
           if sys_.x_true is not None else float("nan"))
    print(f"done in {time.time()-t0:.2f}s: residual {final_res:.3e}  "
          f"rel-error {err:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
