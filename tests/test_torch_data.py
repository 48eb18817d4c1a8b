"""The port's data layer against the JAX reference: generators, block
systems, spectral analysis, the device rule and the import boundary;
and the synthetic LM data: tests/test_data.py's four synthetic cases on
the port (determinism, host sharding, the label shift, the vocabulary),
and the port's int64 batches equal to the reference's int32 ones for
several steps, hosts and configs, on the device asked for (a card by
default)."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import partition as ref_partition  # noqa: E402
from repro.core import spectral as ref_spectral  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro_torch import device as dev  # noqa: E402
from repro_torch.core import blockops, partition, spectral  # noqa: E402
from repro_torch.data import linsys, synthetic  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

GENERATORS = {
    "standard_gaussian": dict(n=48, m=4, seed=1),
    "nonzero_mean_gaussian": dict(n=48, m=4, N=64, seed=2),
    "tall_gaussian": dict(N=96, n=40, m=4, seed=3),
    "conditioned_gaussian": dict(n=64, m=4, cond=20.0, seed=4),
}


def _same(ref_sys, port_sys):
    for field in ("A_blocks", "b_blocks", "x_true"):
        a = np.asarray(getattr(ref_sys, field))
        b = getattr(port_sys, field).numpy()
        assert a.dtype == b.dtype == np.float64, field
        assert np.array_equal(a, b), field
    assert ref_sys.mode == port_sys.mode
    assert ref_sys.structure == port_sys.structure
    if ref_sys.is_sparse:
        assert port_sys.cols.dtype == torch.int64
        assert np.array_equal(np.asarray(ref_sys.cols), port_sys.cols.numpy())


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bit_identical(name):
    kw = GENERATORS[name]
    _same(getattr(ref_linsys, name)(**kw),
          getattr(linsys, name)(**kw, device="cpu"))


# orsirr1 (1030 x 1030) goes through the same matrix_market_proxy as
# qc324 and ash608 and costs the most to draw, so it is left out here;
# its key is checked below.
@pytest.mark.parametrize("key", sorted(set(linsys.ALL_PROBLEMS)
                                       - {"orsirr1"}))
def test_all_problems_bit_identical(key):
    _same(ref_linsys.ALL_PROBLEMS[key](seed=5),
          linsys.ALL_PROBLEMS[key](seed=5, device="cpu"))


def test_all_problems_are_the_reference_dense_entries():
    """Every entry of the reference's ALL_PROBLEMS, the sparse and
    least-squares ones included."""
    assert set(linsys.ALL_PROBLEMS) == set(ref_linsys.ALL_PROBLEMS)
    assert linsys.MM_PROXIES == {
        k: linsys.MatrixMarketProxy(*v.__dict__.values())
        for k, v in ref_linsys.MM_PROXIES.items()}


def test_partition_and_padding_agree():
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((30, 12)), rng.standard_normal(30)
    for m in (3, 4, 7):
        ra, rb = ref_partition.pad_to_blocks(A, b, m)
        pa, pb = partition.pad_to_blocks(A, b, m, device="cpu")
        assert np.array_equal(np.asarray(ra), pa.numpy())
        assert np.array_equal(np.asarray(rb), pb.numpy())
        rs = ref_partition.partition(ra, rb, m)
        ps = partition.partition(pa, pb, m)
        assert np.array_equal(np.asarray(rs.A_blocks), ps.A_blocks.numpy())
        assert np.array_equal(np.asarray(rs.b_blocks), ps.b_blocks.numpy())
        assert (rs.m, rs.p, rs.n, rs.N, rs.mode) == (
            ps.m, ps.p, ps.n, ps.N, ps.mode)
    with pytest.raises(ValueError, match="must divide"):
        partition.partition(A, b, 4, device="cpu")


def test_blockops_match_einsum():
    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.standard_normal((3, 5, 9)))
    x = torch.as_tensor(rng.standard_normal(9))
    D = torch.as_tensor(rng.standard_normal((3, 9)))
    X = torch.as_tensor(rng.standard_normal((2, 9)))
    u = torch.as_tensor(rng.standard_normal((3, 5)))
    An, Dn, un = A.numpy(), D.numpy(), u.numpy()
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), b, rtol=1e-13, atol=1e-13)
    close(blockops.bmatvec(A, x), An @ x.numpy())
    close(blockops.bmatvec_each(A, D), np.einsum("mpn,mn->mp", An, Dn))
    close(blockops.bmatvec_many(A, X), np.einsum("mpn,kn->kmp", An,
                                                 X.numpy()))
    close(blockops.brmatvec(A, u), np.einsum("mpn,mp->mn", An, un))
    close(blockops.brmatvec_sum(A, u), np.einsum("mpn,mp->n", An, un))
    close(blockops.bgram(A), np.einsum("mpn,mqn->mpq", An, An))


@pytest.mark.parametrize("n,m,cond,seed", [(32, 4, 10.0, 0), (48, 3, 50.0, 1),
                                           (64, 8, 5.0, 2)])
def test_spectral_agrees(n, m, cond, seed):
    rs = ref_linsys.conditioned_gaussian(n=n, m=m, cond=cond, seed=seed)
    ps = linsys.conditioned_gaussian(n=n, m=m, cond=cond, seed=seed,
                                     device="cpu")
    Xr = ref_spectral.x_matrix(rs)
    Xp = spectral.x_matrix(ps)
    np.testing.assert_allclose(Xp.numpy(), Xr, rtol=1e-10,
                               atol=1e-10 * np.abs(Xr).max())
    mr, mp = ref_spectral.mu_extremes(Xr), spectral.mu_extremes(Xp)
    np.testing.assert_allclose(mp, mr, rtol=1e-10)
    pr, pp = ref_spectral.apc_optimal(*mr), spectral.apc_optimal(*mp)
    np.testing.assert_allclose([pp.gamma, pp.eta, pp.rho],
                               [pr.gamma, pr.eta, pr.rho], rtol=1e-10)
    assert spectral.convergence_time(pp.rho) == pytest.approx(
        ref_spectral.convergence_time(pr.rho), rel=1e-10)
    for rho in (0.0, 1.0, 1.5):
        assert (spectral.convergence_time(rho)
                == ref_spectral.convergence_time(rho))


def test_device_none_raises_without_cuda(monkeypatch):
    """The no-fallback rule: without a CUDA device, an entry point called
    without device= raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linsys.standard_gaussian(n=8, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition.partition(np.eye(4), np.ones(4), 2)
    assert dev.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="not supported"):
        dev.resolve("meta")


def test_sparse_and_least_squares_generators_not_ported():
    """Ported since: a noisy tall system is a least-squares system, and a
    sparse system needs its cols support."""
    ls = linsys.tall_gaussian(N=16, n=8, m=2, noise=0.5, device="cpu")
    assert ls.mode == "least_squares"
    A = torch.zeros(2, 2, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="cols"):
        partition.BlockSystem(A, torch.zeros(2, 2), structure="sparse")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            head = mod.split(".")[0]
            assert head not in ("jax", "jaxlib", "repro"), (path, mod)


# ---------------------------------------------------------------------------
# synthetic LM data
# ---------------------------------------------------------------------------


def _batch(cfg, step, **kw):
    return synthetic.make_batch(cfg, step, device="cpu", **kw)


def test_batches_deterministic():
    cfg = synthetic.DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    b1, b2 = _batch(cfg, 7), _batch(cfg, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], _batch(cfg, 8)["tokens"])


def test_host_sharding_partitions_global_batch():
    cfg = synthetic.DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    full = _batch(cfg, 3)
    shards = [_batch(cfg, 3, host_id=h, num_hosts=4) for h in range(4)]
    assert torch.equal(torch.cat([s["tokens"] for s in shards]),
                       full["tokens"])
    with pytest.raises(ValueError, match="split"):
        _batch(cfg, 3, num_hosts=3)


def test_labels_are_next_token():
    cfg = synthetic.DataConfig(vocab_size=100, seq_len=12, global_batch=2)
    b = _batch(cfg, 0)
    assert b["tokens"].shape == (2, 12)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_tokens_in_vocab():
    cfg = synthetic.DataConfig(vocab_size=50, seq_len=64, global_batch=4)
    b = _batch(cfg, 2)
    assert int(b["tokens"].max()) < 50 and int(b["tokens"].min()) >= 0


@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=16,
                                     global_batch=4),
                                dict(vocab_size=32000, seq_len=128,
                                     global_batch=8, seed=7),
                                dict(vocab_size=50, seq_len=9,
                                     global_batch=6, zipf_a=1.5, ngram=2)])
def test_batches_equal_the_references(kw):
    cfg = synthetic.DataConfig(**kw)
    ref = ref_synthetic.DataConfig(**kw)
    hosts = [(0, 1), (1, 2)] + ([(2, 3)] if cfg.global_batch % 3 == 0
                                else [])
    for host_id, num_hosts in hosts:
        it = synthetic.batches(cfg, 5, host_id=host_id, num_hosts=num_hosts,
                               device="cpu")
        ref_it = ref_synthetic.batches(ref, 5, host_id=host_id,
                                       num_hosts=num_hosts)
        for _ in range(3):
            got, want = next(it), next(ref_it)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_make_batch_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = synthetic.DataConfig(vocab_size=10, seq_len=4, global_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.make_batch(cfg, 0)
