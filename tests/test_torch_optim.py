"""The port's optimizer substrate against the JAX reference, on the CPU:
every case of tests/test_optim.py run on the port (AdamW against a
hand-written numpy step, descent, clipping as explicit scaling, the
schedule's shape, the int8 roundtrip's error bound, error feedback's
unbiased sum, the wire bytes), each also held to the reference's values:
AdamW on a carried state and the same gradients bit for bit (moments
within 1e-7), the schedule within 1e-7, the
int8 payload and scales bit for bit and the
dequantized gradients and error buffers within 1e-7.
``interop.adamw_state_from_numpy`` carries a reference state across.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compress as ref_compress  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.optim import adamw, compress, schedule  # noqa: E402

LEAF = lambda x: False  # noqa: E731
TOL = 1e-7


def _quad_problem(n=16, seed=0):
    """tests/test_optim.py's problem, float32, on the port: (loss, x0,
    the numpy arrays of both)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    x0 = {"w": rng.standard_normal(n).astype(np.float32),
          "b": {"v": rng.standard_normal(n).astype(np.float32)}}
    target = rng.standard_normal(n).astype(np.float32)
    At, tt = torch.as_tensor(A), torch.as_tensor(target)

    def loss(p):
        y = At @ p["w"] + p["b"]["v"]
        return torch.sum((y - tt) ** 2)

    p = {"w": torch.as_tensor(x0["w"]),
         "b": {"v": torch.as_tensor(x0["b"]["v"])}}
    return loss, p, (A, x0, target)


def _grad(loss, p):
    leaves = sharding.tree_leaves(p, LEAF)
    q = sharding.tree_unflatten(p, [t.detach().requires_grad_()
                                    for t in leaves])
    g = torch.autograd.grad(loss(q), sharding.tree_leaves(q, LEAF))
    return sharding.tree_unflatten(p, list(g))


def _same_tree(got, want, tol=TOL):
    g = sharding.tree_leaves(got, LEAF)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol)


def test_adamw_matches_manual_reference():
    """One AdamW step against a hand-written numpy implementation (the
    reference's test), and against the reference's update on the same
    gradients."""
    cfg = adamw.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                            weight_decay=0.1, clip_norm=None)
    loss, p, _ = _quad_problem()
    g = _grad(loss, p)
    st = adamw.init(p)
    p2, st2 = adamw.update(cfg, g, st, p)
    for get in (lambda t: t["w"], lambda t: t["b"]["v"]):
        pv = get(p).double().numpy()
        gv = get(g).double().numpy()
        m = 0.1 * gv
        v = 0.01 * gv * gv
        mh = m / (1 - 0.9)
        vh = v / (1 - 0.99)
        ref = pv - 1e-2 * (mh / (np.sqrt(vh) + 1e-8) + 0.1 * pv)
        np.testing.assert_allclose(get(p2).numpy(), ref, rtol=1e-5,
                                   atol=1e-6)
    assert st2.step == 1
    rg = jax.tree.map(lambda t: jnp.asarray(t.numpy()), g)
    rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    want_p, want_st = ref_adamw.update(
        ref_adamw.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                              weight_decay=0.1, clip_norm=None),
        rg, ref_adamw.init(rp), rp)
    _same_tree(p2, want_p)
    _same_tree(st2.m, want_st.m)
    _same_tree(st2.v, want_st.v)


def test_adamw_descends():
    cfg = adamw.AdamWConfig(lr=5e-2, weight_decay=0.0)
    loss, p, _ = _quad_problem()
    st = adamw.init(p)
    l0 = float(loss(p))
    for _ in range(60):
        p, st = adamw.update(cfg, _grad(loss, p), st, p)
    assert float(loss(p)) < 0.2 * l0
    assert st.step == 60


def test_clip_norm_equals_manual_scaling():
    """update(clip=c) == update(clip=None) on grads pre-scaled to norm c."""
    loss, p, _ = _quad_problem()
    g = _grad(loss, p)
    gn = float(adamw.global_norm(g))
    c = gn / 7.0
    p2, _ = adamw.update(adamw.AdamWConfig(lr=1e-2, clip_norm=c,
                                           weight_decay=0.0),
                         g, adamw.init(p), p)
    g_scaled = sharding.tree_map(lambda x: x * (c / gn), g, LEAF)
    p3, _ = adamw.update(adamw.AdamWConfig(lr=1e-2, clip_norm=None,
                                           weight_decay=0.0),
                         g_scaled, adamw.init(p), p)
    np.testing.assert_allclose(p2["w"].numpy(), p3["w"].numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_on_a_carried_state_matches_the_reference(dtype):
    """Three reference steps give a state; carried across
    (``adamw_state_from_numpy``), the port's next update on the same
    gradients and schedule scale is the reference's: moments float32
    whatever the parameter dtype, clipping on, the bias corrections at
    step 4 in float32; the moments within 1e-7, the parameters bit for
    bit in float32 and in bfloat16 (the same float32 arithmetic, then one
    round-to-nearest-even cast)."""
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rp = {"a": jnp.asarray(rng.standard_normal((8, 5)), jdt),
          "n": [{"s": jnp.asarray(rng.standard_normal(7), jdt)}]}
    cfg = ref_adamw.AdamWConfig(lr=3e-3)
    st = ref_adamw.init(rp)
    for _ in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * 4.0, x.dtype), rp)
        rp, st = ref_adamw.update(cfg, g, st, rp, lr_scale=0.5)
    g = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape) * 4.0, x.dtype), rp)
    lr_s = ref_schedule.linear_warmup_cosine(jnp.asarray(7.0), warmup=3,
                                             total=20)
    want_p, want_st = ref_adamw.update(cfg, g, st, rp, lr_scale=lr_s)

    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    pst = interop.adamw_state_from_numpy(st.step, np_(st.m), np_(st.v),
                                         device="cpu")
    assert pst.step == 3
    assert all(t.dtype == torch.float32
               for t in sharding.tree_leaves(pst.m, LEAF))
    pp = interop.params_from_numpy(np_(rp), device="cpu")
    pg = interop.params_from_numpy(np_(g), device="cpu")
    got_p, got_st = adamw.update(
        adamw.AdamWConfig(lr=3e-3), pg, pst, pp,
        lr_scale=schedule.linear_warmup_cosine(7, warmup=3, total=20))
    assert got_st.step == 4
    assert got_p["a"].dtype == dtype
    for got, want in zip(sharding.tree_leaves(got_p, LEAF),
                         jax.tree.leaves(want_p)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    _same_tree(got_st.m, want_st.m)
    _same_tree(got_st.v, want_st.v)
    np.testing.assert_allclose(float(adamw.global_norm(pg)),
                               float(ref_adamw.global_norm(g)), rtol=1e-6)


def test_adamw_state_crosses_by_key_path():
    st = ref_adamw.init({"x": jnp.zeros((2, 3)), "l": [jnp.ones(4)]})
    got = interop.adamw_state_from_numpy(
        *[jax.tree.map(np.asarray, f) for f in st], device="cpu")
    assert isinstance(got, adamw.AdamWState) and got.step == 0
    assert tuple(got.m["x"].shape) == (2, 3) and got.v["l"][0].shape == (4,)
    want = adamw.init({"x": torch.zeros(2, 3), "l": [torch.ones(4)]})
    assert got._fields == want._fields
    for a, b in zip(sharding.tree_leaves(got[1:], LEAF),
                    sharding.tree_leaves(want[1:], LEAF)):
        assert torch.equal(a, b)


def test_schedule_shapes():
    s0 = float(schedule.linear_warmup_cosine(0.0, warmup=10, total=100))
    s10 = float(schedule.linear_warmup_cosine(10.0, warmup=10, total=100))
    s100 = float(schedule.linear_warmup_cosine(100.0, warmup=10, total=100))
    assert s0 == 0.0 and s10 == pytest.approx(1.0) and \
        s100 == pytest.approx(0.1, abs=1e-6)
    assert schedule.constant(5) == 1.0


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 3), (5, 5),
                                          (0, 12)])
def test_schedule_matches_the_reference(warmup, total):
    for step in range(total + 3):
        got = schedule.linear_warmup_cosine(step, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        want = ref_schedule.linear_warmup_cosine(
            jnp.asarray(step, jnp.float32), warmup=warmup, total=total)
        assert abs(float(got) - float(want)) <= TOL, step


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal(1000) * 3.0, dtype=torch.float32)
    qg = compress.quantize(g)
    back = compress.dequantize(qg, g.shape, torch.float32)
    err = (back - g).abs()
    assert float(err.max()) <= float(g.abs().max()) / 254 + 1e-6
    assert qg.q.dtype == torch.int8 and qg.n == 1000
    assert tuple(qg.q.shape) == (4, compress.BLOCK)


@pytest.mark.parametrize("n", [1000, 256, 7])
def test_quantize_matches_the_reference(n):
    """The int8 payload and the scales bit for bit (round half to even on
    both sides, ties included), the roundtrip within 1e-7."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 3.0).astype(np.float32)
    a[:4] = [127.0, -63.5, 0.5, 2.5][:min(4, n)]     # exact ties
    got = compress.quantize(torch.as_tensor(a))
    want = ref_compress.quantize(jnp.asarray(a))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.n == want.n
    np.testing.assert_allclose(
        compress.dequantize(got, (n,), torch.float32).numpy(),
        np.asarray(ref_compress.dequantize(want, (n,), jnp.float32)),
        rtol=0, atol=TOL)


def test_error_feedback_unbiased_sum():
    """Over many steps the sum of the compressed grads tracks the true
    sum; each step's output and error buffer are the reference's."""
    rng = np.random.default_rng(1)
    p = {"w": torch.zeros(512), "b": [torch.zeros((3, 100))]}
    err = compress.init_error(p)
    ref_err = ref_compress.init_error({"w": jnp.zeros(512),
                                       "b": [jnp.zeros((3, 100))]})
    total_true = np.zeros(512)
    total_comp = np.zeros(512)
    for t in range(50):
        gw = rng.standard_normal(512).astype(np.float32)
        gb = rng.standard_normal((3, 100)).astype(np.float32)
        deq, err = compress.compress_decompress(
            {"w": torch.as_tensor(gw), "b": [torch.as_tensor(gb)]}, err)
        want, ref_err = ref_compress.compress_decompress(
            {"w": jnp.asarray(gw), "b": [jnp.asarray(gb)]}, ref_err)
        _same_tree(deq, want)
        _same_tree(err, ref_err)
        total_true += gw
        total_comp += deq["w"].numpy()
    assert np.abs(total_true - total_comp).max() < 0.05


def test_compressed_grads_keep_their_dtype():
    g = {"w": torch.randn(300, generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16)}
    deq, err = compress.compress_decompress(g, compress.init_error(g))
    assert deq["w"].dtype == torch.bfloat16 and err["w"].dtype == \
        torch.float32


def test_wire_bytes_accounting():
    p = {"a": torch.zeros((1000,)), "b": torch.zeros((24,))}
    raw, comp = compress.wire_bytes(p)
    assert raw == 4 * 1024
    assert comp < raw / 3.5
    assert (raw, comp) == ref_compress.wire_bytes(
        {"a": jnp.zeros((1000,)), "b": jnp.zeros((24,))})
