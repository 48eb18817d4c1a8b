"""What every smoke of the port shares.  Importing this module prepends
the repo's src/ to sys.path (idempotent), so the smokes run with or
without PYTHONPATH=src.

``parse(doc, argv)``: the ``--device`` flag (``cuda`` by default, as
every entry point of the port; ``--device cpu`` runs on the host), plus
the rank arguments of a smoke that spawns itself.  ``spawn(...)`` runs
a smoke's own file once a rank over gloo (``--rank R --world W --store
DIR``), with a deadline that kills them all; ``join(args)`` is a spawned
rank's side.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(REPO, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

#: seconds the spawned ranks of a smoke may take, all together
DEADLINE = 100.0


def parse(doc: str, argv=None):
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def spawn(script: str, device: str, world: int = 2,
          deadline: float = DEADLINE) -> None:
    """Run ``script`` once a rank (``--rank R --world W --store DIR
    --device D``), all at once; a rank exiting non-zero, or any rank
    still running after ``deadline`` seconds, fails the smoke."""
    with tempfile.TemporaryDirectory(prefix="smoke_ranks_") as store:
        t = time.time()
        procs = [subprocess.Popen(
            [sys.executable, script, "--rank", str(r), "--world", str(world),
             "--store", store, "--device", device]) for r in range(world)]
        try:
            for p in procs:
                rc = p.wait(timeout=max(1.0, deadline - (time.time() - t)))
                assert rc == 0, f"{script}: a rank exited with {rc}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def join(args):
    """A spawned rank's gloo group (a FileStore in ``args.store``), on
    the CPU or beside the card: two ranks share one card over gloo."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(args.store, "store"),
                                     args.world),
        rank=args.rank, world_size=args.world)
