"""The port's checkpoints and factor store against the JAX reference.

``repro_torch.checkpoint.ckpt`` and ``repro_torch.solvers.store`` are
held to the local cases of tests/test_checkpoint.py and
tests/test_factor_store.py (the mesh and redundant cases wait for ROADMAP
A14/A15), and across the packages: the port's fingerprints are the
reference's hex digests for the same dense, sparse and mixed system, a
checkpoint either package writes the other restores (the counter ``t``
included), and a store-backed history matches the reference's at the
parity tolerances of tests/test_torch_executor.py.  On the CPU; the disk
tier's bf16 entries are checked bit for bit.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.solvers import store as ref_store  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.apc import APCState  # noqa: E402
from repro_torch.core.partition import BlockSystem, partition  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.solvers.store import (FactorStore, block_fingerprint,  # noqa: E402,E501
                                       fingerprint)

torch.set_num_threads(1)

PRM = {"gamma": 1.0, "eta": 1.0}
HIST = dict(rtol=0, atol=1e-9)          # tests/test_torch_executor.py
X_TOL = dict(rtol=1e-9, atol=1e-12)


def _port(ref_sys):
    """The port's copy of a reference system (same bytes)."""
    return interop.system_from_numpy(
        np.asarray(ref_sys.A_blocks), np.asarray(ref_sys.b_blocks),
        None if ref_sys.x_true is None else np.asarray(ref_sys.x_true),
        mode=ref_sys.mode,
        cols=None if ref_sys.cols is None else np.asarray(ref_sys.cols),
        device="cpu")


@pytest.fixture(scope="module")
def sys_a():
    return linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0,
                                       device="cpu")


@pytest.fixture(scope="module")
def sys_b():
    return linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=1,
                                       device="cpu")


def _banded(bandwidth=6):
    return linsys.banded_system(n=96, m=4, bandwidth=bandwidth, seed=0,
                                device="cpu")


def _tree_equal(t1, t2):
    l1, l2 = ckpt.flatten(t1), ckpt.flatten(t2)
    return (ckpt._treedef(t1) == ckpt._treedef(t2) and len(l1) == len(l2)
            and all(type(a) is type(b) and a.dtype == b.dtype
                    and torch.equal(a, b) for a, b in zip(l1, l2)))


def _plan(**kw):
    return solvers.ExecutionPlan(**kw)


# ---------------------------------------------------------------------------
# checkpoints: tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def _tree(v=0.0):
    return {"a": torch.arange(6, dtype=torch.float32) + v,
            "b": {"c": torch.ones((2, 3), dtype=torch.float64) * v,
                  "step": 3}}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree(1.5)
    ckpt.save(d, 10, t)
    out = ckpt.restore(d, _tree())
    assert torch.equal(out["a"], t["a"])
    assert torch.equal(out["b"]["c"], t["b"]["c"])
    assert out["b"]["step"] == 3 and isinstance(out["b"]["step"], int)


def test_latest_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(float(s)), keep=3)
    assert ckpt.latest_step(d) == 5
    assert ckpt.all_steps(d) == [3, 4, 5]
    out = ckpt.restore(d, _tree(), step=4)
    assert float(out["b"]["c"][0, 0]) == 4.0


def test_uncommitted_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1.0))
    # a crash mid-save: a step dir without the COMMIT marker
    os.makedirs(os.path.join(d, "step_0000000002"))
    assert ckpt.latest_step(d) == 1


def test_structure_validation(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    with pytest.raises(ValueError, match="config drift"):
        ckpt.restore(d, {"only": torch.zeros(3)})
    bad = _tree()
    bad["a"] = torch.zeros((7,))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, bad)


def test_resume_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "definitely_missing"), _tree())


def test_restore_dtype_drift_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.arange(4, dtype=torch.float64)})
    like = {"w": torch.zeros(4, dtype=torch.float32)}
    with pytest.raises(ValueError, match="dtype drift"):
        ckpt.restore(d, like)
    out = ckpt.restore(d, like, allow_cast=True)
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], torch.arange(4.0))


def test_restore_same_dtype_unaffected(tmp_path):
    d = str(tmp_path)
    t = _tree(2.0)
    ckpt.save(d, 1, t)
    out = ckpt.restore(d, _tree())
    assert torch.equal(out["a"], t["a"])


def test_manifest_writes_numpy_dtype_names(tmp_path):
    d = str(tmp_path)
    path = ckpt.save(d, 7, APCState(x=torch.zeros(2, 3, dtype=torch.float64),
                                    xbar=torch.zeros(3), t=7))
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert [l["dtype"] for l in manifest["leaves"]] == [
        "float64", "float32", "int32"]
    assert manifest["leaves"][2]["shape"] == [] and manifest["n_leaves"] == 3


def test_bf16_leaf_round_trips_by_its_bits(tmp_path):
    d = str(tmp_path)
    w = torch.randn(5, 7, dtype=torch.float64).to(torch.bfloat16)
    ckpt.save(d, 1, {"w": w})
    out = ckpt.restore(d, {"w": torch.zeros(5, 7, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)


def _ref_and_port_states(iters=25):
    """The same APC solve in both packages: (reference result, port
    result, port system)."""
    rsys = ref_linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0)
    psys = _port(rsys)
    r = ref_solvers.get("apc").solve(rsys, iters=iters, **PRM)
    p = solvers.get("apc").solve(psys, iters=iters, **PRM)
    return rsys, r, psys, p


def test_port_checkpoint_restores_in_reference(tmp_path):
    rsys, r, psys, p = _ref_and_port_states()
    d = str(tmp_path)
    ckpt.save(d, p.state.t, p.state)
    back = ref_ckpt.restore(d, r.state)            # reference's template
    assert back.t.dtype == jnp.int32 and int(back.t) == 25
    assert np.array_equal(np.asarray(back.x), p.state.x.numpy())
    assert np.array_equal(np.asarray(back.xbar), p.state.xbar.numpy())
    # and the reference resumes from it
    w = ref_solvers.get("apc").solve(
        rsys, iters=5, plan=ref_solvers.ExecutionPlan(warm_state=back), **PRM)
    assert int(w.state.t) == 30


def test_reference_checkpoint_restores_in_port(tmp_path):
    rsys, r, psys, p = _ref_and_port_states()
    d = str(tmp_path)
    ref_ckpt.save(d, int(r.state.t), r.state)
    back = ckpt.restore(d, p.state)
    assert back.t == 25 and isinstance(back.t, int)
    assert np.array_equal(back.x.numpy(), np.asarray(r.state.x))
    assert np.array_equal(back.xbar.numpy(), np.asarray(r.state.xbar))
    w = solvers.get("apc").solve(psys, iters=5,
                                 plan=_plan(warm_state=back), **PRM)
    assert w.state.t == 30


# ---------------------------------------------------------------------------
# fingerprints: tests/test_factor_store.py, and the reference's digests
# ---------------------------------------------------------------------------


def test_fingerprint_is_content_addressed(sys_a, sys_b):
    k = fingerprint("apc", sys_a, PRM)
    assert k == fingerprint("apc", sys_a, PRM)
    assert k != fingerprint("apc", sys_b, PRM)
    assert k != fingerprint("cimmino", sys_a, PRM)
    assert k != fingerprint("apc", sys_a, {"gamma": 1.5, "eta": 1.0})


def test_fingerprint_normalizes_numeric_param_types(sys_a):
    k_py = fingerprint("apc", sys_a, {"gamma": 1.25, "eta": 1.5})
    k_np = fingerprint("apc", sys_a, {"gamma": np.float64(1.25),
                                      "eta": torch.tensor(1.5)})
    assert k_py == k_np


def test_fingerprint_sees_partition_not_just_content(sys_a):
    A, b = sys_a.dense()
    re2 = partition(A, b, 2, x_true=sys_a.x_true)
    assert fingerprint("apc", sys_a, PRM) != fingerprint("apc", re2, PRM)


def test_fingerprint_separates_sparse_from_densified():
    sp = _banded()
    assert sp.is_sparse
    assert fingerprint("apc", sp, PRM) != fingerprint("apc", sp.densified(),
                                                      PRM)


def test_dense_fingerprint_ignores_sparse_fields():
    sp = _banded()
    rebuilt = BlockSystem(sp.A_blocks, sp.b_blocks, x_true=sp.x_true)
    assert fingerprint("apc", sp.densified(), PRM) == fingerprint(
        "apc", rebuilt, PRM)


def test_fingerprint_sees_sparse_support_pattern():
    assert fingerprint("apc", _banded(6), PRM) != fingerprint(
        "apc", _banded(8), PRM)


@pytest.mark.parametrize("kind,precision", [
    ("dense", "default"), ("sparse", "default"), ("dense", "mixed"),
    ("sparse", "mixed"), ("ls", "default")])
def test_fingerprint_hex_equals_reference(kind, precision):
    """Byte-identical digests: the same tokens, the dtype by its numpy
    name, a sparse support hashed as the reference's int32 ``cols``."""
    rsys = {"dense": lambda: ref_linsys.conditioned_gaussian(
                n=48, m=4, cond=10.0, seed=0),
            "sparse": lambda: ref_linsys.banded_system(
                n=96, m=4, bandwidth=6, seed=0),
            "ls": lambda: ref_linsys.tall_gaussian(
                N=96, n=48, m=4, noise=0.05, seed=0)}[kind]()
    psys = _port(rsys)
    assert psys.cols is None or psys.cols.dtype == torch.int64
    for name in ("apc", "cimmino"):
        prm = {k: float(v) for k, v in
               ref_solvers.get(name).resolve_params(rsys).items()}
        assert fingerprint(name, psys, prm, precision) == \
            ref_store.fingerprint(name, rsys, prm, precision)
        # and the store's key, with the params resolved on each side
        assert FactorStore().key(name, psys, precision=precision, **prm) == \
            ref_store.FactorStore().key(name, rsys, precision=precision,
                                        **prm)


def test_block_fingerprint_hex_equals_reference():
    rsys = ref_linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0)
    psys = _port(rsys)
    for i in range(psys.m):
        for precision in ("default", "mixed"):
            assert block_fingerprint("apc", psys.A_blocks[i], PRM,
                                     precision) == \
                ref_store.block_fingerprint(
                    "apc", np.asarray(rsys.A_blocks[i]), PRM, precision)


# ---------------------------------------------------------------------------
# memory tier and the kernel augmentation
# ---------------------------------------------------------------------------


def test_memory_hit_returns_same_object(sys_a):
    store = FactorStore()
    s = solvers.get("apc")
    f1 = store.factors(s, sys_a, **PRM)
    f2 = store.factors(s, sys_a, **PRM)
    assert f2 is f1
    assert store.stats.misses == 1 and store.stats.hits == 1


def test_lru_eviction(sys_a, sys_b):
    store = FactorStore(capacity=1)
    s = solvers.get("apc")
    store.factors(s, sys_a, **PRM)
    store.factors(s, sys_b, **PRM)                        # evicts sys_a
    assert len(store) == 1 and store.stats.evictions == 1
    store.factors(s, sys_a, **PRM)                        # miss again
    assert store.stats.misses == 3 and store.stats.hits == 0


def test_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        FactorStore(capacity=0)
    with pytest.raises(ValueError, match="block_capacity"):
        FactorStore(block_capacity=0)


def test_kernel_factors_idempotent(sys_a):
    s = solvers.get("apc")
    aug = s.kernel_factors(s.prepare(sys_a.A_blocks, PRM))
    assert aug.B is not None
    assert s.kernel_factors(aug) is aug


def test_store_augments_entry_once(sys_a):
    store = FactorStore()
    s = solvers.get("apc")
    f1 = store.factors(s, sys_a, use_kernel=True, **PRM)
    assert f1.B is not None
    f2 = store.factors(s, sys_a, use_kernel=True, **PRM)
    f3 = store.factors(s, sys_a, **PRM)
    assert f2 is f1 and f3 is f1
    assert store.stats.misses == 1 and store.stats.hits == 2


def test_mixed_entry_is_cast_last_and_stays_bf16(sys_a):
    store = FactorStore()
    s = solvers.get("apc")
    f = store.factors(s, sys_a, use_kernel=True, precision="mixed", **PRM)
    assert f.A.dtype == f.B.dtype == torch.bfloat16
    assert f.chol.dtype == torch.float64
    # the cast happened after the float64 augmentation
    full = s.kernel_factors(s.prepare(sys_a.A_blocks, PRM))
    assert torch.equal(f.B, full.B.to(torch.bfloat16))
    assert store.factors(s, sys_a, use_kernel=True, precision="mixed",
                         **PRM) is f
    # a full-precision request never sees the cast entry
    g = store.factors(s, sys_a, use_kernel=True, **PRM)
    assert g.A.dtype == torch.float64 and store.stats.misses == 2


# ---------------------------------------------------------------------------
# solve(plan=ExecutionPlan(store=...))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,precision", [
    (False, "default"), (True, "default"), (True, "mixed")])
def test_solve_through_store_is_bit_exact(sys_a, kernel, precision):
    s = solvers.get("apc")
    fresh = s.solve(sys_a, iters=40, plan=_plan(kernel=kernel,
                                                precision=precision), **PRM)
    store = FactorStore()
    for _ in range(2):
        r = s.solve(sys_a, iters=40, plan=_plan(
            kernel=kernel, precision=precision, store=store), **PRM)
        assert torch.equal(r.residuals, fresh.residuals)
        assert torch.equal(r.x, fresh.x)
    assert store.stats.misses == 1 and store.stats.hits == 1


def test_solve_many_through_store(sys_a):
    s = solvers.get("apc")
    B = np.random.default_rng(0).standard_normal((3, sys_a.N))
    fresh = s.solve_many(sys_a, B, iters=40, **PRM)
    store = FactorStore()
    for _ in range(2):
        r = s.solve_many(sys_a, B, iters=40, plan=_plan(store=store), **PRM)
        assert torch.equal(r.residuals, fresh.residuals)
    assert store.stats.misses == 1 and store.stats.hits == 1


def test_resume_without_cached_factors_counts_as_miss(sys_a, caplog):
    s = solvers.get("apc")
    prior = s.solve(sys_a, iters=10, **PRM)
    store = FactorStore()
    with caplog.at_level("WARNING", logger="repro_torch.solvers.store"):
        s.solve(sys_a, iters=10,
                plan=_plan(warm_state=prior.state, store=store), **PRM)
    assert store.stats.resume_misses == 1 and store.stats.misses == 1
    assert any("warm-start resume" in r.message for r in caplog.records)
    s.solve(sys_a, iters=10, plan=_plan(warm_state=prior.state, store=store),
            **PRM)
    assert store.stats.resume_misses == 1 and store.stats.hits == 1


@pytest.mark.parametrize("name,kind", [("apc", "dense"), ("cimmino", "ls"),
                                       ("apc", "sparse")])
def test_store_backed_history_matches_reference(name, kind):
    """The same store-backed solve in both packages, twice each (a miss
    then a hit), at the parity tolerances."""
    rsys = {"dense": lambda: ref_linsys.conditioned_gaussian(
                n=48, m=4, cond=10.0, seed=0),
            "sparse": lambda: ref_linsys.banded_system(
                n=96, m=4, bandwidth=6, seed=0),
            "ls": lambda: ref_linsys.tall_gaussian(
                N=96, n=48, m=4, noise=0.05, seed=0)}[kind]()
    psys = _port(rsys)
    prm = {k: float(v) for k, v in
           ref_solvers.get(name).resolve_params(rsys).items()}
    rstore, pstore = ref_store.FactorStore(), FactorStore()
    for _ in range(2):
        r = ref_solvers.get(name).solve(
            rsys, iters=37, plan=ref_solvers.ExecutionPlan(store=rstore),
            **prm)
        p = solvers.get(name).solve(psys, iters=37,
                                    plan=_plan(store=pstore), **prm)
        tol = HIST if kind != "sparse" else dict(rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(p.residuals.numpy(),
                                   np.asarray(r.residuals), **tol)
        np.testing.assert_allclose(p.x.numpy(), np.asarray(r.x), **X_TOL)
    assert (pstore.stats.misses, pstore.stats.hits) == \
        (rstore.stats.misses, rstore.stats.hits) == (1, 1)


# ---------------------------------------------------------------------------
# disk tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kernel,precision", [
    ("apc", False, "default"), ("pdhbm", False, "default"),
    ("apc", True, "mixed"), ("cimmino", True, "mixed")])
def test_disk_round_trip_bit_exact(tmp_path, sys_a, name, kernel, precision):
    s = solvers.get(name)
    prm = s.resolve_params(sys_a)
    kw = dict(use_kernel=kernel, precision=precision, **prm)
    store1 = FactorStore(directory=str(tmp_path))
    f_fresh = store1.factors(s, sys_a, **kw)
    assert store1.stats.disk_writes == 1
    # a COLD store over the same directory: a restarted process
    store2 = FactorStore(directory=str(tmp_path))
    f_restored = store2.factors(s, sys_a, **kw)
    assert store2.stats.disk_hits == 1 and store2.stats.misses == 0
    assert _tree_equal(f_fresh, f_restored)
    if precision == "mixed":
        assert f_restored.A.dtype == f_restored.B.dtype == torch.bfloat16
    plan = dict(kernel=kernel, precision=precision)
    r_fresh = s.solve(sys_a, iters=40, plan=_plan(factors=f_fresh, **plan),
                      **prm)
    r_rest = s.solve(sys_a, iters=40, plan=_plan(factors=f_restored, **plan),
                     **prm)
    assert torch.equal(r_fresh.residuals, r_rest.residuals)
    assert torch.equal(r_fresh.x, r_rest.x)


@pytest.mark.parametrize("name", ["apc", "cimmino"])
def test_sparse_disk_round_trip_bit_exact(tmp_path, name):
    sp = _banded()
    s = solvers.get(name)
    prm = s.resolve_params(sp)
    store1 = FactorStore(directory=str(tmp_path))
    f_fresh = store1.factors(s, sp, **prm)
    assert store1.stats.disk_writes == 1
    store2 = FactorStore(directory=str(tmp_path))
    f_restored = store2.factors(s, sp, **prm)
    assert store2.stats.disk_hits == 1 and store2.stats.misses == 0
    assert _tree_equal(f_fresh, f_restored)
    r_fresh = s.solve(sp, iters=60, plan=_plan(factors=f_fresh), **prm)
    r_rest = s.solve(sp, iters=60, plan=_plan(factors=f_restored), **prm)
    assert torch.equal(r_fresh.residuals, r_rest.residuals)
    assert torch.equal(r_fresh.x, r_rest.x)


def _tamper(tmp_path, key, field, value):
    path = tmp_path / key / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest[field] = value
    path.write_text(json.dumps(manifest))


def test_sparse_manifest_records_structure_and_rejects_drift(tmp_path):
    sp = _banded()
    s = solvers.get("apc")
    prm = s.resolve_params(sp)
    store = FactorStore(directory=str(tmp_path))
    store.factors(s, sp, **prm)
    key = store.key(s, sp, **prm)
    manifest = json.loads((tmp_path / key / "manifest.json").read_text())
    assert manifest["system_structure"] == "sparse"
    _tamper(tmp_path, key, "system_structure", "dense")
    with pytest.raises(ValueError, match="holds 'dense' factors"):
        FactorStore(directory=str(tmp_path)).factors(s, sp, **prm)


def test_disk_entry_layout_matches_checkpoint_contract(tmp_path, sys_a):
    s = solvers.get("apc")
    store = FactorStore(directory=str(tmp_path))
    store.factors(s, sys_a, **PRM)
    key = store.key(s, sys_a, **PRM)
    entry = tmp_path / key
    assert (entry / ckpt.COMMIT).exists()
    assert ckpt.COMMIT == ref_ckpt.COMMIT
    manifest = json.loads((entry / "manifest.json").read_text())
    assert manifest["solver"] == "apc" and manifest["dtype"] == "float64"
    assert manifest["partition"] == [sys_a.m, sys_a.p, sys_a.n]
    assert manifest["structure"]["cls"] == \
        "repro_torch.solvers.projection:ProjFactors"
    assert all((entry / f"leaf_{i:05d}.npy").exists()
               for i in range(len(manifest["leaves"])))


def test_uncommitted_entry_is_ignored(tmp_path, sys_a):
    s = solvers.get("apc")
    store = FactorStore(directory=str(tmp_path))
    store.factors(s, sys_a, **PRM)
    key = store.key(s, sys_a, **PRM)
    os.remove(tmp_path / key / ckpt.COMMIT)                # crashed mid-write
    store2 = FactorStore(directory=str(tmp_path))
    store2.factors(s, sys_a, **PRM)
    assert store2.stats.misses == 1 and store2.stats.disk_hits == 0


@pytest.mark.parametrize("field,value,match", [
    ("dtype", "float32", "dtype"),
    ("partition", [8, 6, 48], "partition"),
    ("solver", "cimmino", "solver"),
])
def test_manifest_drift_fails_loudly(tmp_path, sys_a, field, value, match):
    s = solvers.get("apc")
    store = FactorStore(directory=str(tmp_path))
    store.factors(s, sys_a, **PRM)
    key = store.key(s, sys_a, **PRM)
    _tamper(tmp_path, key, field, value)
    with pytest.raises(ValueError, match=match):
        FactorStore(directory=str(tmp_path)).factors(s, sys_a, **PRM)


def test_corrupt_leaf_fails_loudly(tmp_path, sys_a):
    s = solvers.get("apc")
    store = FactorStore(directory=str(tmp_path))
    store.factors(s, sys_a, **PRM)
    key = store.key(s, sys_a, **PRM)
    np.save(tmp_path / key / "leaf_00000.npy", np.zeros((2, 2)))
    with pytest.raises(ValueError, match="corrupt"):
        FactorStore(directory=str(tmp_path)).factors(s, sys_a, **PRM)


def test_reference_entry_is_not_read(tmp_path):
    """The fingerprints agree, so a shared directory holds the other
    package's entry under the same key: the port refuses it loudly."""
    rsys = ref_linsys.conditioned_gaussian(n=48, m=4, cond=10.0, seed=0)
    ref_store.FactorStore(directory=str(tmp_path)).factors(
        ref_solvers.get("apc"), rsys, **PRM)
    store = FactorStore(directory=str(tmp_path))
    with pytest.raises(ValueError, match="does not read"):
        store.factors(solvers.get("apc"), _port(rsys), **PRM)


# ---------------------------------------------------------------------------
# block tier
# ---------------------------------------------------------------------------


def test_blockwise_factors_reuse_counts(tmp_path, sys_a):
    s = solvers.get("apc")
    store = FactorStore(directory=str(tmp_path))
    f1, reuse1 = store.blockwise_factors(s, sys_a, **PRM)
    assert reuse1 == (0, sys_a.m)
    assert _tree_equal(f1, s.prepare(sys_a.A_blocks, PRM))
    # a system sharing two of the four blocks reuses exactly those
    A2 = sys_a.A_blocks.clone()
    A2[1] *= 2.0
    A2[3] += 1.0
    sys2 = BlockSystem(A2, sys_a.b_blocks)
    f2, reuse2 = store.blockwise_factors(s, sys2, **PRM)
    assert reuse2 == (2, 2)
    assert (store.stats.block_hits, store.stats.block_misses) == (2, 6)
    assert _tree_equal(f2, s.prepare(A2, PRM))
    # the assembly seeded the whole-system tier: a plain call hits
    assert store.factors(s, sys2, **PRM) is f2
    # and a cold store reuses every block from disk
    cold = FactorStore(directory=str(tmp_path))
    _, reuse3 = cold.blockwise_factors(s, sys2, use_kernel=True, **PRM)
    assert reuse3 == (4, 0)


def test_blockwise_factors_validation(sys_a):
    store = FactorStore()
    with pytest.raises(ValueError, match="supports_block_store"):
        store.blockwise_factors(solvers.get("dgd"), sys_a)
    with pytest.raises(ValueError, match="dense-only"):
        store.blockwise_factors(solvers.get("apc"), _banded(), **PRM)
    assert solvers.get("consensus").supports_block_store
    assert solvers.get("cimmino").supports_block_store
