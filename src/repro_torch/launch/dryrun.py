"""Multi-pod dry-run: trace every (architecture x shape) cell on the
production meshes and record per-device memory, FLOPs, bytes and
collectives against the H100's roofline (the port's counterpart of
``repro.launch.dryrun``).

The meshes are the reference's, (16, 16) and (2, 16, 16), over torch's
fake process group of 256 or 512 ranks in this one process
(``mesh.make_production_mesh``; the group becomes the process's default
group, so run this as its own process).  Every tensor is a ``meta``
tensor: nothing is allocated and no card is needed, the twin of the
reference's placeholder devices.  Each cell's step runs once under
``analysis.Counter``, which counts what one device does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --multi-pod --json out.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver --both-meshes
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import analysis, cells, mesh as mesh_lib

# what a cell that fails to place or trace raises: the diagnostic this
# tool exists to surface.  Anything else (KeyboardInterrupt, SystemExit)
# is a fault of the tool and propagates.
CELL_FAILURES = (ValueError, TypeError, KeyError, AttributeError,
                 NotImplementedError, RuntimeError, AssertionError,
                 IndexError)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             compile_: bool = True, verbose: bool = True) -> dict:
    """One LM cell: its record, ``status`` "ok" (counted), "lowered"
    (placed and traced, counting nothing: ``compile_`` false) or
    "skipped"."""
    cfg = configs.get(arch)
    ok, reason = cells.applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod)}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    counter, meta = cells.trace_cell(arch, shape_name, mesh, cfg=cfg,
                                     count=compile_)
    rec["trace_s"] = round(time.time() - t0, 1)
    if not compile_:
        rec.update(status="lowered", **meta)
        return rec
    rec["memory"] = analysis.memory_record(counter)
    roof = analysis.from_counter(f"{arch}/{shape_name}",
                                 tuple(mesh.mesh.shape), counter,
                                 meta["model_flops"])
    rec.update(status="ok", **meta, roofline=roof.row(),
               collectives={k: v for k, v in roof.collectives.items() if v},
               collective_links={"nvlink": counter.cost.coll_nvlink,
                                 "network": counter.cost.coll_network})
    if verbose:
        r = roof.row()
        print(f"  {arch:22s} {shape_name:12s} {rec['mesh']:8s} "
              f"trace {rec['trace_s']:6.1f}s  peak "
              f"{rec['memory']['peak_bytes'] / 1e9:8.2f} GB"
              f"{'' if rec['memory']['fits_80gb'] else ' (> 80 GB)'}  "
              f"t_comp {r['t_compute']:.3e}  t_mem {r['t_memory']:.3e}  "
              f"t_coll {r['t_collective']:.3e}  -> {r['bottleneck']}",
              flush=True)
    return rec


def run_solver_cell(*, multi_pod: bool, dtype: str = "float64",
                    n: int = 1 << 20, p: int = 2048,
                    verbose: bool = True) -> dict:
    """The roofline of one mesh APC iteration (the paper's workload:
    ``core.distributed.ShardedAPC``'s step, the unfused Cholesky one) on
    the production mesh, its shards ``meta`` tensors: the m worker
    blocks over the worker axes, n over ``model``.  float64 is the
    paper's; float32 halves the wire and HBM bytes."""
    from repro_torch.core import distributed
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    worker_axes = ("pod", "data") if multi_pod else ("data",)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    m = 1
    for a in worker_axes:
        m *= sizes[a]
    solver = distributed.make_sharded_apc(
        mesh, worker_axes=worker_axes, model_axis="model",
        gamma=1.26, eta=1.85)
    dt = getattr(torch, dtype)
    n_loc = n // sizes["model"]
    meta = lambda *shape: torch.empty(shape, dtype=dt,  # noqa: E731
                                      device="meta")
    # this rank's shards: one worker block of (p, n / model) and its
    # Gram Cholesky, the local iterate and the mean's column shard
    args = (meta(1, p, n_loc), meta(1, p, p), meta(1, n_loc), meta(n_loc))
    t0 = time.time()
    counter = analysis.Counter(args)
    with counter, torch.no_grad():
        solver.step_fn()(*args)
    # useful work: the paper's 2pn multiply-adds per worker per iteration
    model_flops = 2.0 * (2.0 * p * n) * m
    roof = analysis.from_counter(f"apc-solver/{dtype}",
                                 tuple(mesh.mesh.shape), counter,
                                 model_flops)
    rec = {"arch": "apc-solver", "shape": f"iter_n{n}_p{p}_{dtype}",
           "mesh": _mesh_name(multi_pod), "status": "ok",
           "model_flops": model_flops,
           "trace_s": round(time.time() - t0, 1),
           "memory": analysis.memory_record(counter),
           "roofline": roof.row(),
           "collectives": {k: v for k, v in roof.collectives.items() if v},
           "collective_links": {"nvlink": counter.cost.coll_nvlink,
                                "network": counter.cost.coll_network}}
    if verbose:
        r = roof.row()
        print(f"  apc-solver {dtype:8s} {rec['mesh']:8s} m={m} p={p} n={n}  "
              f"t_comp {r['t_compute']:.3e}  t_mem {r['t_memory']:.3e}  "
              f"t_coll {r['t_collective']:.3e}  -> {r['bottleneck']}",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--json", default=None, help="write records to this file")
    ap.add_argument("--no-compile", action="store_true",
                    help="place and trace only, counting nothing (fast "
                         "structural check)")
    ap.add_argument("--solver", action="store_true",
                    help="run the APC-solver roofline cells instead of the "
                         "LM cells (float64 paper-faithful + float32)")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.solver:
        records, failures = [], 0
        for mp in meshes:
            for dtype in ("float64", "float32"):
                try:
                    records.append(run_solver_cell(multi_pod=mp, dtype=dtype))
                except CELL_FAILURES as e:
                    print(f"solver cell FAILED [{type(e).__name__}]",
                          file=sys.stderr)
                    traceback.print_exc()
                    records.append({"arch": "apc-solver", "shape": dtype,
                                    "mesh": _mesh_name(mp),
                                    "status": "FAILED",
                                    "error_type": type(e).__name__,
                                    "error": repr(e)})
                    failures += 1
        if args.json:
            with open(args.json, "w") as f:
                json.dump(records, f, indent=1)
        print(f"\nsolver dry-run: {len(records) - failures} ok, "
              f"{failures} FAILED")
        return 1 if failures else 0

    archs = [args.arch] if args.arch else configs.ARCHS
    shapes = [args.shape] if args.shape else list(cells.SHAPES)

    records, failures = [], 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   compile_=not args.no_compile)
                except CELL_FAILURES as e:
                    print(f"cell FAILED [{type(e).__name__}]",
                          file=sys.stderr)
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(mp), "status": "FAILED",
                           "error_type": type(e).__name__,
                           "error": repr(e)}
                    failures += 1
                records.append(rec)
                if rec["status"] == "skipped":
                    print(f"  {arch:22s} {shape:12s} skipped: "
                          f"{rec['reason'][:60]}...", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    n_ok = sum(r["status"] in ("ok", "lowered") for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {failures} FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
