"""The port's Mamba2 (SSD) block against the JAX reference, on the CPU.

The cases of tests/test_ssm.py run through both packages on the same
seeded inputs: ``ssd_chunked`` at chunk 8, 16 and 64 (and the sequential
recurrence of ``ssd_step``), the prefill-state hand-off (chunked on a
prefix, then stepped), and the causal conv in its train and step forms.
Each is held to the reference within 2e-5 * (max|ref| + 1) in float32 and
8e-2 in bfloat16, and every output's dtype is the reference's: in
bfloat16 the chunked scan returns y and the state in float32, a step its
state in float32 and y in bfloat16.  ``ssm_apply`` (train, prefill and a
decode step on carried parameters) likewise, its new cache's dtypes
included, and ``L % chunk`` is still asserted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 8e-2)}


def _pair(a, dtype):
    """(the port's tensor, the reference's array) of float32 ``a`` in
    ``dtype`` (float32 ``A`` stays float32, as the block passes it)."""
    tdt, jdt, _ = DTYPES[dtype]
    aj = jnp.asarray(a, jdt)
    return torch.as_tensor(np.array(aj.astype(jnp.float32))).to(tdt), aj


def _inputs(dtype, B=2, L=64, H=3, P=8, N=16, seed=0):
    """tests/test_ssm.py's inputs, as (port, reference) pairs."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, L, H, P)) * 0.5).astype(f)
    dt = rng.uniform(0.01, 0.2, (B, L, H)).astype(f)
    A = (-rng.uniform(0.5, 2.0, (H,))).astype(f)
    Bm = (rng.standard_normal((B, L, N)) * 0.3).astype(f)
    Cm = (rng.standard_normal((B, L, N)) * 0.3).astype(f)
    return ([_pair(t, dtype) for t in (x, dt)] + [_pair(A, "float32")]
            + [_pair(t, dtype) for t in (Bm, Cm)])


def _close(got, want, tol):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                                want.dtype)
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(np.asarray(want.astype(jnp.float32)), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * (np.max(np.abs(want)) + 1.0), err


def _sequential(mod, x, dt, A, Bm, Cm, zeros):
    """Token by token through ``mod.ssd_step`` from a float32 zero state."""
    state, ys = zeros, []
    for t in range(x.shape[1]):
        state, y = mod.ssd_step(state, x[:, t], dt[:, t], A, Bm[:, t],
                                Cm[:, t])
        ys.append(y)
    return ys, state


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_matches_the_reference(chunk, dtype):
    pairs = _inputs(dtype)
    port, ref = [p for p, _ in pairs], [r for _, r in pairs]
    tol = DTYPES[dtype][2]
    y, h = ssm.ssd_chunked(*port, chunk=chunk)
    y_ref, h_ref = ref_ssm.ssd_chunked(*ref, chunk=chunk)
    _close(y, y_ref, tol)
    _close(h, h_ref, tol)
    assert y.dtype == h.dtype == torch.float32
    if dtype == "float32":       # and the sequential recurrence
        B, L, H, P = port[0].shape
        ys, hs = _sequential(ssm, *port, torch.zeros(
            (B, H, port[3].shape[-1], P)))
        np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(h.numpy(), hs.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_step_matches_the_reference(dtype):
    pairs = _inputs(dtype, L=8)
    port, ref = [p for p, _ in pairs], [r for _, r in pairs]
    tol = DTYPES[dtype][2]
    B, L, H, P = port[0].shape
    N = port[3].shape[-1]
    for start_dtype in (DTYPES[dtype][0], torch.float32):
        rng = np.random.default_rng(7)
        s0, s0_ref = _pair(rng.standard_normal((B, H, N, P)).astype(
            np.float32), dtype)
        s0 = s0.to(start_dtype)
        if start_dtype == torch.float32:
            s0_ref = s0_ref.astype(jnp.float32)
        ys, s = _sequential(ssm, *port, s0)
        ys_ref, s_ref = _sequential(ref_ssm, *ref, s0_ref)
        for got, want in zip(ys, ys_ref):
            _close(got, want, tol)
        _close(s, s_ref, tol)
        # the state widens to float32; y keeps the inputs' dtype
        assert s.dtype == torch.float32 and ys[0].dtype == port[0].dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_final_state_continues_decode(dtype):
    """Chunked on a 16-token prefix, then stepped from its final state:
    the reference's outputs at every step."""
    pairs = _inputs(dtype, L=32)
    port, ref = [p for p, _ in pairs], [r for _, r in pairs]
    tol = DTYPES[dtype][2]
    head = lambda ts, a, b: [t[:, a:b] if t.ndim > 1 else t  # noqa: E731
                             for t in ts]
    _, h16 = ssm.ssd_chunked(*head(port, 0, 16), chunk=8)
    _, h16_ref = ref_ssm.ssd_chunked(*head(ref, 0, 16), chunk=8)
    _close(h16, h16_ref, tol)
    ys, _ = _sequential(ssm, *head(port, 16, 32), h16)
    ys_ref, _ = _sequential(ref_ssm, *head(ref, 16, 32),
                            h16_ref.astype(jnp.float32))
    for got, want in zip(ys, ys_ref):
        _close(got, want, tol)
    if dtype == "float32":       # and the full sequential run
        B, L, H, P = port[0].shape
        y_all, _ = _sequential(ssm, *port, torch.zeros(
            (B, H, port[3].shape[-1], P)))
        for t, got in enumerate(ys):
            np.testing.assert_allclose(got.numpy(), y_all[16 + t].numpy(),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_matches_the_reference(dtype):
    rng = np.random.default_rng(1)
    Cch, dw, L = 6, 4, 12
    tol = DTYPES[dtype][2]
    w, wj = _pair(rng.standard_normal((dw, Cch)).astype(np.float32), dtype)
    b, bj = _pair(rng.standard_normal((Cch,)).astype(np.float32), dtype)
    u, uj = _pair(rng.standard_normal((2, L, Cch)).astype(np.float32), dtype)
    full = ssm._causal_conv_train(w, b, u)
    full_ref = ref_ssm._causal_conv_train(wj, bj, uj)
    _close(full, full_ref, tol)
    cache = torch.zeros((2, dw - 1, Cch), dtype=u.dtype)
    cache_ref = jnp.zeros((2, dw - 1, Cch), uj.dtype)
    for t in range(L):
        out, cache = ssm._causal_conv_step(w, b, cache, u[:, t:t + 1])
        out_ref, cache_ref = ref_ssm._causal_conv_step(wj, bj, cache_ref,
                                                       uj[:, t:t + 1])
        _close(out, out_ref, tol)
        _close(cache, cache_ref, tol)
        if dtype == "float32":
            np.testing.assert_allclose(out[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_matches_the_reference(dtype):
    """``ssm_apply`` on mamba2's smoke config, carried parameters: train
    over 64 tokens (two chunks of 32), prefill of 32, then two decode
    steps; outputs and new caches, with their dtypes."""
    tdt, jdt, tol = DTYPES[dtype]
    ref_cfg = ref_configs.get_smoke("mamba2-130m")
    cfg = configs.get_smoke("mamba2-130m")
    rp = ref_sharding.init_tree(ref_ssm.ssm_abstract(ref_cfg),
                                jax.random.PRNGKey(0), jdt)
    pp = interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                   device="cpu")
    rng = np.random.default_rng(3)
    x, xj = _pair(rng.standard_normal((2, 64, cfg.d_model)).astype(
        np.float32), dtype)
    y, c = ssm.ssm_apply(cfg, pp, x)
    y_ref, c_ref = ref_ssm.ssm_apply(ref_cfg, rp, xj)
    assert c is None and c_ref is None
    _close(y, y_ref, tol)
    zero = {k: torch.zeros(s.shape, dtype=tdt) for k, s in
            ssm.ssm_cache_abstract(cfg, 2).items()}
    zero_ref = {k: jnp.zeros(s.shape, jdt) for k, s in
                ref_ssm.ssm_cache_abstract(ref_cfg, 2).items()}
    y, c = ssm.ssm_apply(cfg, pp, x[:, :32], cache=zero)
    y_ref, c_ref = ref_ssm.ssm_apply(ref_cfg, rp, xj[:, :32], cache=zero_ref)
    _close(y, y_ref, tol)
    for t in (32, 33):
        for k in ("conv", "state"):
            _close(c[k], c_ref[k], tol)
        y, c = ssm.ssm_apply(cfg, pp, x[:, t:t + 1], cache=c)
        y_ref, c_ref = ref_ssm.ssm_apply(ref_cfg, rp, xj[:, t:t + 1],
                                         cache=c_ref)
        _close(y, y_ref, tol)
    assert c["state"].dtype == torch.float32 and c["conv"].dtype == tdt


def test_chunk_must_divide_the_length():
    pairs = _inputs("float32", L=24)
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(*[p for p, _ in pairs], chunk=16)


def test_long_chunk_differences_taken_in_float64():
    """The deliberate difference (ROADMAP C): the port takes the
    within-chunk cumsum and its differences in float64.  At chunk 256 with
    dt in [0.5, 1.1] (|cs| up to ~280) the reference's float32 cumsum
    cancels in cs_i - cs_j; against the float64 reference the port's
    float32 y errs 16x less than the reference's float32 y, and the two
    stay well within the float32 parity bound."""
    rng = np.random.default_rng(0)
    B, L, H, P, N = 1, 512, 2, 4, 8
    raw = [rng.standard_normal((B, L, H, P)) * 0.5,
           rng.uniform(0.5, 1.1, (B, L, H)), -rng.uniform(0.5, 1.0, (H,)),
           rng.standard_normal((B, L, N)) * 0.3,
           rng.standard_normal((B, L, N)) * 0.3]
    truth, _ = ref_ssm.ssd_chunked(*[jnp.asarray(a, jnp.float64)
                                     for a in raw], chunk=256)
    ref, _ = ref_ssm.ssd_chunked(*[jnp.asarray(a, jnp.float32) for a in raw],
                                 chunk=256)
    got, _ = ssm.ssd_chunked(*[torch.as_tensor(a.astype(np.float32))
                               for a in raw], chunk=256)
    truth = np.asarray(truth)
    scale = np.max(np.abs(truth)) + 1.0
    ref_err = np.max(np.abs(np.asarray(ref, np.float64) - truth)) / scale
    err = np.max(np.abs(got.numpy().astype(np.float64) - truth)) / scale
    assert ref_err > 5e-7 and err < ref_err / 8, (err, ref_err)
    _close(got, ref, 2e-5)
