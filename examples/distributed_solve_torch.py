"""Distributed APC on a mesh of ranks (twin of
examples/distributed_solve.py, whose 4 workers x 2 column-shards mesh
lives on 8 forced host devices).

The script starts its own ranks (``--ranks``, default 8, each a process
in one gloo group through a file store), or joins the group ``torchrun``
set up.  The mesh is (ranks / model) workers x ``--model`` column
shards; rank 0 prints.

    PYTHONPATH=src python examples/distributed_solve_torch.py [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 8 \
        examples/distributed_solve_torch.py --device cpu
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch import device as dev
from repro_torch import solvers
from repro_torch.core import distributed
from repro_torch.data import linsys
from repro_torch.launch import mesh as mesh_lib

DEADLINE = 300.0       # seconds the spawned ranks may take together


def solve(args, device):
    import torch.distributed as dist
    rank = dist.get_rank()
    model = min(args.model, dist.get_world_size())
    mesh = mesh_lib.solver_mesh(dist.get_world_size() // model, model,
                                device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say("mesh:", mesh)

    sys_ = linsys.conditioned_gaussian(n=256, m=4, cond=30.0, seed=1,
                                       device=mesh_lib.mesh_device(mesh))
    xbar, residual = distributed.solve_on_mesh(mesh, sys_, iters=400)
    x_true = sys_.x_true
    err = float((xbar - x_true).norm() / x_true.norm())
    say(f"distributed APC: residual {residual:.3e}  rel-error {err:.3e}")

    # single-host reference through the unified registry surface
    ref = solvers.get("apc").solve(sys_, iters=400)
    d = float((xbar - ref.x).norm())
    say(f"max deviation from single-host reference: {d:.3e}")
    assert d < 1e-8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--model", type=int, default=2,
                    help="column shards (the mesh's model axis)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = dev.resolve(args.device)
    import torch.distributed as dist
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        mesh_lib.init_group(device)
    elif args.rank is None:             # start the ranks, then wait
        with tempfile.TemporaryDirectory(prefix="distributed_solve_") as d:
            t = time.time()
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--device", args.device,
                 "--ranks", str(args.ranks), "--model", str(args.model),
                 "--rank", str(r), "--store", d])
                for r in range(args.ranks)]
            try:
                for p in procs:
                    rc = p.wait(timeout=max(1.0, DEADLINE - (time.time() - t)))
                    assert rc == 0, f"a rank exited with {rc}"
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        return
    else:
        # ranks share a card over gloo (NCCL takes one rank a card); one
        # thread a rank, as torchrun sets: the host's cores are shared
        import torch
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(args.store, "store"),
                                         args.ranks),
            rank=args.rank, world_size=args.ranks)
    try:
        solve(args, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
