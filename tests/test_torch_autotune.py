"""The port's engine and tile choice (``repro_torch.kernels.ops``) against
the JAX reference's (``repro.kernels.ops``).

The twin of tests/test_engine_autotune.py (all eight tests) and of the
tile-pin tests of tests/test_kernel_corners.py: every question asked of
``use_fused``/``pick_tiles``/``pick_bn`` is asked of both packages under
one environment (the two read the same variables), and their verdicts,
caches and exceptions compare equal; the dispatch tests hold the port's
histories bit-equal to its unfused path where the reference holds its
own so.  Then what the port adds: the card's k-chunk (``launch_kc``),
the mixed-precision key, the measured path on the CPU, and no
measurement inside a capture or after an executor's build.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import solvers as ref_solvers  # noqa: E402
from repro.data import linsys as ref_linsys  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.solvers.store import FactorStore as RefStore  # noqa: E402
from repro_torch import solvers  # noqa: E402
from repro_torch.analysis import tracecheck  # noqa: E402
from repro_torch.data import linsys  # noqa: E402
from repro_torch.kernels import block_projection as bp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.solvers import executor  # noqa: E402

torch.set_num_threads(1)

PRM_APC = {"gamma": 1.0, "eta": 1.0}
ENV = (ops.ENGINE_ENV, ops.AUTOTUNE_ENV, ops.BN_ENV, ops.BP_ENV, ops.BK_ENV)


def _clear():
    for mod in (ops, ref_ops):
        mod.engine_cache_clear()
        mod.tile_cache_clear()
        mod.bn_cache_clear()


@pytest.fixture(autouse=True)
def _clean_caches(monkeypatch):
    # heuristic-only resolution by default: deterministic on any host
    assert (ops.ENGINE_ENV, ops.AUTOTUNE_ENV, ops.BN_ENV, ops.BP_ENV,
            ops.BK_ENV) == (ref_ops.ENGINE_ENV, ref_ops.AUTOTUNE_ENV,
                            ref_ops.BN_ENV, ref_ops.BP_ENV, ref_ops.BK_ENV)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(ops.AUTOTUNE_ENV, "0")
    _clear()
    yield
    _clear()


@pytest.fixture(scope="module")
def systems():
    kw = dict(n=64, m=2, cond=10.0, seed=0)
    return (ref_linsys.conditioned_gaussian(**kw),
            linsys.conditioned_gaussian(**kw, device="cpu"))


def _both(*args, **kw):
    """use_fused of both packages on the same question (float32 unless
    given), the verdicts equal; returns it."""
    dtype = kw.pop("dtype", "float32")
    got = ops.use_fused(*args, dtype=getattr(torch, dtype), **kw)
    want = ref_ops.use_fused(*args, dtype=getattr(jnp, dtype), **kw)
    assert got is want, (args, kw)
    return got


def _raises_both(exc, match, fn):
    """``fn(module)`` raises ``exc`` in both packages."""
    for mod in (ops, ref_ops):
        with pytest.raises(exc, match=match):
            fn(mod)


# ---------------------------------------------------------------------------
# resolution order (tests/test_engine_autotune.py)
# ---------------------------------------------------------------------------


def test_env_pin_wins_and_skips_the_cache(monkeypatch):
    monkeypatch.setenv(ops.ENGINE_ENV, "fused")
    assert _both("cimmino", 32, 128, 1) is True
    monkeypatch.setenv(ops.ENGINE_ENV, "unfused")
    assert _both("apc", 32, 128, 16) is False
    assert ops.engine_cache() == ref_ops.engine_cache() == {}
    monkeypatch.setenv(ops.ENGINE_ENV, "both")
    _raises_both(ValueError, "fused",
                 lambda mod: mod.use_fused("apc", 32, 128, 1))


def test_heuristic_cimmino_subbatch_falls_back():
    assert _both("cimmino", 32, 128, 1) is False
    assert _both("cimmino", 32, 128, 4) is True
    assert _both("cimmino", 32, 128, 16) is True
    assert _both("apc", 32, 128, 1) is True
    assert _both("apc", 32, 128, 16) is True
    assert _both("cimmino_sparse", 32, 1024, 1, w=130) is False
    assert _both("apc_sparse", 32, 1024, 1, w=130) is True


def test_choice_is_cached_per_padded_shape():
    _both("cimmino", 30, 100, 1)
    key = ("cimmino", 32, 128, 1, "float32")
    assert ops.engine_cache() == ref_ops.engine_cache() == {key: False}
    _both("apc", 32, 128, 9)
    _both("apc", 32, 128, 16)
    _both("apc_sparse", 30, 1000, 3, w=77, dtype="float64")
    assert ("apc", 32, 128, 16, "float32") in ops.engine_cache()
    assert ("apc_sparse", 32, 1024, 8, 77, "float64") in ops.engine_cache()
    assert ops.engine_cache() == ref_ops.engine_cache()
    assert len(ops.engine_cache()) == 3
    assert ops.engine_key("apc_sparse", 30, 1000, 3, torch.float64,
                          w=77) == ("apc_sparse", 32, 1024, 8, 77, "float64")


def test_measured_autotune_runs_and_caches(monkeypatch):
    """REPRO_KERNEL_AUTOTUNE=1 measures on the CPU too (the plain
    versions against the unfused step): a verdict, cached under the
    reference's key, recorded with tracecheck, and a cache hit the second
    time."""
    monkeypatch.setenv(ops.AUTOTUNE_ENV, "1")
    with tracecheck() as tc:
        got = ops.use_fused("cimmino", 16, 128, 1, torch.float32,
                            device="cpu")
        again = ops.use_fused("cimmino", 16, 128, 1, torch.float32,
                              device="cpu")
    want = ref_ops.use_fused("cimmino", 16, 128, 1, jnp.float32,
                             interpret=True)
    assert isinstance(got, bool) and again is got
    assert set(ops.engine_cache()) == set(ref_ops.engine_cache()) == {
        ("cimmino", 16, 128, 1, "float32")}
    assert isinstance(want, bool)
    assert [e.fun for e in tc.traces()] == ["measure engine cimmino"]
    fused_s, unfused_s = ops.engine_times[("cimmino", 16, 128, 1,
                                           "float32")]
    assert got == (fused_s <= ops._ENGINE_MARGIN * unfused_s)


@pytest.mark.parametrize("family,k,w", [("apc", 1, None),
                                        ("apc", 3, None),
                                        ("apc_sparse", 1, 40),
                                        ("cimmino_sparse", 8, 40)])
def test_measured_families_on_the_cpu(monkeypatch, family, k, w):
    """Every family's measurement runs (dense and sparse, k = 1 and a
    batch) and caches a bool; no launch is counted."""
    monkeypatch.setenv(ops.AUTOTUNE_ENV, "1")
    before = ops.launch_counts()
    got = ops.use_fused(family, 16, 256, k, torch.float64, w=w,
                        device="cpu")
    assert isinstance(got, bool)
    assert ops.engine_cache() == {ops.engine_key(family, 16, 256, k,
                                                 torch.float64, w=w): got}
    assert ops.launch_counts() == before


def test_unknown_family_rejected():
    _raises_both(ValueError, "family",
                 lambda mod: mod.use_fused("dgd", 32, 128, 1))


def test_use_fused_sparse_family_requires_w():
    """tests/test_kernel_corners.py::test_use_fused_sparse_family_requires_w"""
    _raises_both(ValueError, "support width w",
                 lambda mod: mod.use_fused("apc_sparse", 8, 256, 16))


# ---------------------------------------------------------------------------
# dispatch (tests/test_engine_autotune.py)
# ---------------------------------------------------------------------------


def _solve_many(pkg, sys_, B, kernel, **prm):
    Store = RefStore if pkg is ref_solvers else solvers.FactorStore
    return pkg.get(prm.pop("name")).solve_many(
        sys_, B, iters=25, plan=pkg.ExecutionPlan(kernel=kernel,
                                                  store=Store()), **prm)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_cimmino_batch1_dispatch_bit_equals_unfused(systems):
    """With the verdict 'unfused' (the heuristic at k = 1), kernel=True
    runs the IDENTICAL unfused step: bit-equal, in both packages."""
    rs, ps = systems
    b = np.random.default_rng(0).standard_normal(ps.N)
    kern = _solve_many(solvers, ps, b[None], True, name="cimmino")
    ref = _solve_many(solvers, ps, b[None], False, name="cimmino")
    assert torch.equal(kern.x, ref.x)
    rkern = _solve_many(ref_solvers, rs, b[None], True, name="cimmino")
    rref = _solve_many(ref_solvers, rs, b[None], False, name="cimmino")
    assert np.array_equal(np.asarray(rkern.x), np.asarray(rref.x))
    np.testing.assert_allclose(_np(kern.x), np.asarray(rkern.x), rtol=1e-10,
                               atol=1e-12)
    assert ops.engine_cache() == ref_ops.engine_cache() == {
        ("cimmino", 32, 128, 1, "float64"): False}


def test_cimmino_batch1_pin_forces_the_fused_kernels(monkeypatch, systems):
    rs, ps = systems
    b = np.random.default_rng(0).standard_normal(ps.N)
    monkeypatch.setenv(ops.ENGINE_ENV, "fused")
    kern = _solve_many(solvers, ps, b[None], True, name="cimmino")
    ref = _solve_many(solvers, ps, b[None], False, name="cimmino")
    # genuinely a different engine (different rounding), same solve
    assert not torch.equal(kern.x, ref.x)
    assert torch.allclose(kern.x, ref.x, rtol=1e-10, atol=1e-12)
    rkern = _solve_many(ref_solvers, rs, b[None], True, name="cimmino")
    np.testing.assert_allclose(_np(kern.x), np.asarray(rkern.x), rtol=1e-10,
                               atol=1e-12)


def test_apc_dispatch_keeps_fused_at_batch_16(systems):
    rs, ps = systems
    B = np.random.default_rng(1).standard_normal((16, ps.N))
    kern = _solve_many(solvers, ps, B, True, name="apc", **PRM_APC)
    ref = _solve_many(solvers, ps, B, False, name="apc", **PRM_APC)
    assert torch.allclose(kern.x, ref.x, rtol=1e-8, atol=1e-10)
    rkern = _solve_many(ref_solvers, rs, B, True, name="apc", **PRM_APC)
    np.testing.assert_allclose(_np(kern.x), np.asarray(rkern.x), rtol=1e-8,
                               atol=1e-10)
    assert ops.engine_cache() == ref_ops.engine_cache() == {
        ("apc", 32, 128, 16, "float64"): True}


@pytest.mark.parametrize("structure", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["apc", "consensus", "cimmino"])
def test_unfused_pin_falls_back_bit_exactly(monkeypatch, structure, name):
    """REPRO_KERNEL_ENGINE=unfused: kernel=True is the unfused solve bit
    for bit (x and the step's state), dense and sparse, as the
    reference's measured fallback."""
    if structure == "dense":
        sys_ = linsys.conditioned_gaussian(n=64, m=4, cond=10.0, seed=3,
                                           device="cpu")
    else:
        sys_ = linsys.banded_system(n=96, m=4, bandwidth=4, seed=0,
                                    device="cpu")
    monkeypatch.setenv(ops.ENGINE_ENV, "unfused")
    s = solvers.get(name)
    kern = s.solve(sys_, iters=30, plan=solvers.ExecutionPlan(kernel=True))
    plain = s.solve(sys_, iters=30)
    assert torch.equal(kern.x, plain.x)


def test_mixed_precision_asks_with_the_stored_dtype(systems):
    """Under precision="mixed" both packages ask use_fused with the bf16
    stored matrix's dtype (the reference's factors.A.dtype): the same
    cache, and at k = 1 Cimmino's heuristic verdict (unfused) runs the
    unfused step on the bf16-rounded blocks in both."""
    rs, ps = systems
    plan = dict(kernel=True, precision="mixed")
    got = solvers.get("cimmino").solve(
        ps, iters=10, plan=solvers.ExecutionPlan(**plan))
    want = ref_solvers.get("cimmino").solve(
        rs, iters=10, plan=ref_solvers.ExecutionPlan(**plan))
    assert ops.engine_cache() == ref_ops.engine_cache() == {
        ("cimmino", 32, 128, 1, "bfloat16"): False}
    np.testing.assert_allclose(_np(got.residuals), np.asarray(want.residuals),
                               rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# tiles (tests/test_kernel_corners.py) and the card's k-chunk
# ---------------------------------------------------------------------------


def test_tile_env_pins(monkeypatch):
    monkeypatch.setenv(ops.BN_ENV, "128")
    monkeypatch.setenv(ops.BP_ENV, "8")
    monkeypatch.setenv(ops.BK_ENV, "8")
    got = ops.pick_tiles(1024, 32, 16, torch.float32)
    want = ref_ops.pick_tiles(1024, 32, 16, np.dtype(np.float32),
                              interpret=True)
    assert got == tuple(want) == (128, 8, 8)
    assert ops.tile_cache() == ref_ops.tile_cache() == {}


@pytest.mark.parametrize("env,value", [(ops.BP_ENV, "24"),
                                       (ops.BK_ENV, "24"),
                                       (ops.BN_ENV, "384")])
def test_tile_env_pin_rejects_nondivisor(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=env):
        ops.pick_tiles(1024, 32, 16, torch.float32)
    with pytest.raises(ValueError, match=env):
        ref_ops.pick_tiles(1024, 32, 16, np.dtype(np.float32),
                           interpret=True)


@pytest.mark.parametrize("n_pad,p_pad,k_pad,dtype", [
    (1024, 32, 16, "float32"), (128, 8, 1, "float64"),
    (896, 24, 8, "float64"), (16384, 2048, 8, "bfloat16"),
    (384, 8, 1, "float32")])
def test_heuristic_tiles_and_caches_equal(n_pad, p_pad, k_pad, dtype):
    """Unpinned and unmeasured, the port's (bn, bp, bk) and both caches
    are the reference's heuristic ones."""
    got = ops.pick_tiles(n_pad, p_pad, k_pad, getattr(torch, dtype))
    want = ref_ops.pick_tiles(n_pad, p_pad, k_pad, getattr(jnp, dtype),
                              interpret=True)
    assert got == tuple(want)
    assert ops.tile_cache() == ref_ops.tile_cache()
    assert ops.bn_cache() == ref_ops.bn_cache()
    assert ops.pick_bn(n_pad, p_pad, getattr(torch, dtype)) == \
        ref_ops.pick_bn(n_pad, p_pad, getattr(jnp, dtype), interpret=True)


def test_launch_kc_takes_a_pinned_chunk(monkeypatch):
    """The card's KC: the library's own (None) unless REPRO_KERNEL_BK pins
    one of block_projection.KC_VALUES; a pinned divisor the library does
    not instantiate raises naming them, from every op, on the CPU too."""
    A = torch.zeros((2, 8, 128), dtype=torch.float64)
    X = torch.zeros((2, 16, 128), dtype=torch.float64)
    Xb = torch.zeros((16, 128), dtype=torch.float64)
    assert ops.launch_kc(A, 128, 8, 16, torch.float64) is None
    for kc in bp.KC_VALUES:
        monkeypatch.setenv(ops.BK_ENV, str(kc))
        assert ops.launch_kc(A, 128, 8, 16, torch.float64) == kc
    monkeypatch.setenv(ops.BK_ENV, "16")
    with pytest.raises(ValueError, match=r"\(1, 2, 4, 8\)"):
        ops.launch_kc(A, 128, 8, 16, torch.float64)
    with pytest.raises(ValueError, match=ops.BK_ENV):
        ops.proj_gather(A, X, Xb)
    with pytest.raises(ValueError, match="k-chunk"):
        bp._kc(3)
    assert bp._kc(None) == 0 and bp._kc(8) == 8


def test_no_measurement_inside_a_capture(monkeypatch):
    """A measurement on the card inside a CUDA graph capture raises: the
    verdicts are resolved before a capture."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        ops._no_capture("the engine verdict", torch.device("cuda"))
    ops._no_capture("the engine verdict", torch.device("cpu"))


def test_executor_resolves_before_its_build(monkeypatch):
    """LocalExecutor measures the engine verdict before it builds (the
    first run's events: the measurement, then the build), and never
    again: the second run is quiet."""
    monkeypatch.setenv(ops.AUTOTUNE_ENV, "1")
    sys_ = linsys.conditioned_gaussian(n=64, m=2, cond=10.0, seed=0,
                                       device="cpu")
    s = solvers.get("apc")
    fac = s.kernel_factors(s.prepare(sys_.A_op, {}))
    ex = executor.LocalExecutor(s, PRM_APC, 20, use_kernel=True)
    Bb = sys_.b_blocks.expand(3, -1, -1).contiguous()
    with tracecheck() as tc:
        ex.run(sys_.A_op, fac, Bb)
    assert [e.fun for e in tc.traces()] == ["measure engine apc",
                                            "build apc.cold"]
    with tracecheck(steady_state=True):
        ex.run(sys_.A_op, fac, Bb)
    assert ops.engine_key("apc", 32, 64, 3, torch.float64) in \
        ops.engine_cache()
