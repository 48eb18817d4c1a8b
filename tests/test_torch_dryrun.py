"""The port's dry-run (``repro_torch.launch.{analysis,cells,dryrun}``) on
the CPU.

* **The counter** counts one device's work: a 10-layer loop counts 10x
  one layer; a batched product's FLOPs follow from its shapes; the
  (256, 4096) @ (4096, 4096) bf16 product with its weight split 16 ways
  over the fake (16, 16) mesh counts 2·256·4096·4096/16 FLOPs on the
  device (torch's ``FlopCounterMode`` alone counts 16x that: the global
  op), and its redistribute to ``Replicate`` one all-gather of the
  output's bytes, over the hosts' network (16 ranks span two 8-card
  hosts).
* **One cell end to end**: ``python -m repro_torch.launch.dryrun --arch
  whisper-tiny --shape train_4k --multi-pod`` prints ``0 FAILED`` (the
  twin of tests/test_system.py::test_dryrun_single_cell_subprocess); its
  argument bytes are the sum over the parameters, the AdamW moments and
  the batch of each leaf's bytes over the product of its sharded mesh
  sizes (``pspec_tree``); its roofline row passes
  tests/test_artifacts.py's checks of a row.  The float64 solver cell's
  ``model_flops`` is 2·(2pn)·m.

The fake process group becomes the default group of the process that
starts it, so every case that needs it runs in a subprocess.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _layer(x, w):
    return torch.relu(x @ w) + x


def test_a_loop_of_layers_counts_each_layer():
    from repro_torch.launch import analysis
    x = torch.randn(8, 32)
    w = torch.randn(32, 32)
    with analysis.Counter() as one:
        _layer(x, w)
    with analysis.Counter() as ten:
        y = x
        for _ in range(10):
            y = _layer(y, w)
    assert one.cost.flops > 2 * 8 * 32 * 32
    assert ten.cost.flops == pytest.approx(10 * one.cost.flops)
    assert ten.cost.bytes == pytest.approx(10 * one.cost.bytes)
    assert ten.cost.coll_total() == 0


def test_batched_product_flops_follow_the_shapes():
    from repro_torch.launch import analysis
    a = torch.randn(3, 5, 7, dtype=torch.float64)
    b = torch.randn(3, 7, 11, dtype=torch.float64)
    with analysis.Counter() as c:
        torch.bmm(a, b)
    assert c.cost.flops == 2 * 3 * 5 * 7 * 11
    assert c.cost.bytes == 8 * (3 * 5 * 7 + 3 * 7 * 11 + 3 * 5 * 11)
    assert c.cost.compute_s == pytest.approx(
        c.cost.flops / analysis.PEAK_BY_DTYPE[torch.float64])
    with analysis.Counter() as e:
        torch.einsum("bik,bkj->bij", a, b)
    assert e.cost.flops >= c.cost.flops


PRODUCT = """
import json, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import analysis, mesh as mesh_lib
mesh = mesh_lib.make_production_mesh()
meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
x = distribute_tensor(meta(256, 4096), mesh, [Replicate(), Replicate()])
w = distribute_tensor(meta(4096, 4096), mesh, [Replicate(), Shard(1)])
with FlopCounterMode(display=False) as fc:
    x @ w
with analysis.Counter((x, w)) as prod:
    y = x @ w
with analysis.Counter() as gather:
    y.redistribute(mesh, [Replicate(), Replicate()])
print(json.dumps({"global": fc.get_total_flops(), "flops": prod.cost.flops,
                  "coll": prod.cost.coll_total(), "args": prod.argument_bytes,
                  "gather": gather.cost.coll, "network":
                  gather.cost.coll_network, "nvlink": gather.cost.coll_nvlink,
                  "placements": [p.is_replicate() or p.is_shard(1)
                                 for p in y.placements]}))
"""


def test_a_column_sharded_product_counts_one_devices_work():
    r = subprocess.run([sys.executable, "-c", PRODUCT], env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    mm = 2 * 256 * 4096 * 4096
    assert got["global"] == mm                   # the trap: the global op
    assert got["flops"] == mm / 16
    assert got["coll"] == 0
    assert got["args"] == 2 * (256 * 4096 + 4096 * 4096 // 16)
    assert got["placements"] == [True, True]      # (Replicate, Shard(1))
    out_bytes = 2 * 256 * 4096
    assert got["gather"]["all-gather"] == out_bytes
    assert sum(got["gather"].values()) == out_bytes
    assert got["network"] == out_bytes and got["nvlink"] == 0


def _dryrun(tmp_path, *args):
    out = str(tmp_path / "cells.json")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--json", out], env=ENV, capture_output=True,
                       text=True, timeout=900)
    return r, json.load(open(out)) if os.path.exists(out) else None


def _pieces(pspec, mesh_sizes) -> int:
    """How many pieces a leaf of spec ``pspec`` is cut into."""
    return math.prod(mesh_sizes[a] for entry in pspec if entry is not None
                     for a in (entry if isinstance(entry, tuple)
                               else (entry,)))


def _expected_argument_bytes(arch, shape, names, sizes):
    """Σ over the train step's arguments of each leaf's bytes over the
    product of its sharded mesh sizes, from ``pspec_tree``."""
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.models import model, sharding
    cfg = configs.get(arch)
    rules = sharding.rules_for_mesh(type("M", (), {
        "mesh_dim_names": names})())
    mesh_sizes = dict(zip(names, sizes))
    ab = model.model_abstract(cfg)
    specs = sharding.tree_leaves(sharding.pspec_tree(ab, rules),
                                 sharding.is_pspec)
    width = torch.finfo(model.cache_dtype(cfg)).bits // 8
    total = 0
    for s, p in zip(sharding.tree_leaves(ab), specs):
        n = math.prod(s.shape) // _pieces(p, mesh_sizes)
        total += n * (width + 4 + 4)      # the leaf, its two f32 moments
    sds, ispecs = cells.input_specs(cfg, shape, rules)
    for t, p in zip(sharding.tree_leaves(sds, lambda x: False),
                    sharding.tree_leaves(ispecs, sharding.is_pspec)):
        total += t.numel() * t.element_size() // _pieces(p, mesh_sizes)
    return total


def test_one_multi_pod_cell_end_to_end(tmp_path):
    r, recs = _dryrun(tmp_path, "--arch", "whisper-tiny", "--shape",
                      "train_4k", "--multi-pod")
    assert "0 FAILED" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    (rec,) = recs
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["memory"]["argument_bytes"] == _expected_argument_bytes(
        "whisper-tiny", "train_4k", ("pod", "data", "model"), (2, 16, 16))
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    f = rec["roofline"]
    assert f["chips"] == 512
    assert f["t_compute"] > 0 and f["t_memory"] > 0
    assert f["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < f["useful_ratio"] < 1.5
    assert 0 <= f["roofline_fraction"] <= 1.0
    assert f["coll_bytes_dev"] == pytest.approx(
        sum(rec["collectives"].values()))
    assert f["coll_bytes_dev"] == pytest.approx(
        sum(rec["collective_links"].values()))


def test_the_solver_cells(tmp_path):
    r, recs = _dryrun(tmp_path, "--solver", "--both-meshes")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "0 FAILED" in r.stdout
    assert [(x["mesh"], x["shape"].rsplit("_", 1)[1]) for x in recs] == [
        ("16x16", "float64"), ("16x16", "float32"),
        ("2x16x16", "float64"), ("2x16x16", "float32")]
    n, p = 1 << 20, 2048
    for x in recs:
        m = 32 if x["mesh"] == "2x16x16" else 16
        assert x["model_flops"] == 2.0 * (2.0 * p * n) * m
        f = x["roofline"]
        assert f["t_compute"] > 0 and f["t_memory"] > 0
        assert x["collectives"].get("all-reduce", 0) > 0
        # one block of (p, n / 16) and its Cholesky factor on a device
        width = 8 if x["shape"].endswith("float64") else 4
        assert x["memory"]["argument_bytes"] == width * (
            p * n // 16 + p * p + 2 * n // 16)
