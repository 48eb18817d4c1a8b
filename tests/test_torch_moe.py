"""The port's MoE layer against the JAX reference, on the CPU.

Each case of tests/test_moe.py runs through both packages on the same
parameters (the reference's ``init_tree`` draw, carried across with
``interop.params_from_numpy``) and the same inputs, the port held to the
reference within 2e-5 * (max|ref| + 1) in float32: unbounded capacity
(and the naive per-token loop), a capacity factor of 0.25 (the same
entries drop), the always-on shared expert, and normalized gates.  Beyond
them: ``_capacity`` over a grid, a tied router (two identical columns)
choosing the experts ``jax.lax.top_k`` chooses, the lower id first, which
``torch.topk`` does not promise; and bfloat16 on the same input within
8e-2, the same experts routed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import config as ref_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import config, layers, moe  # noqa: E402

torch.set_num_threads(1)

F32 = 2e-5          # x (max|ref| + 1), float32, port against reference
BF16 = 8e-2


def _cfgs(E=8, K=2, D=16, F=32, cf=8.0, n_shared=0):
    """(the reference's config, the port's) of tests/test_moe.py's shape."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, head_dim=8, d_ff=F, vocab_size=64)
    mo = dict(num_experts=E, top_k=K, d_expert=F, capacity_factor=cf,
              n_shared=n_shared)
    return (ref_config.ModelConfig(**kw, moe=ref_config.MoEConfig(**mo)),
            config.ModelConfig(**kw, moe=config.MoEConfig(**mo)))


def _params(ref_cfg, seed=0, dtype=jnp.float32):
    rp = ref_sharding.init_tree(ref_moe.moe_abstract(ref_cfg),
                                jax.random.PRNGKey(seed), dtype)
    return rp, interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                         device="cpu")


def _x(key, shape, scale):
    xj = scale * jax.random.normal(jax.random.PRNGKey(key), shape,
                                   jnp.float32)
    return xj, torch.as_tensor(np.array(xj))


def _close(got, want, tol):
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * (np.max(np.abs(want)) + 1.0), err


def test_matches_the_reference_when_capacity_unbounded():
    ref_cfg, cfg = _cfgs(cf=32.0)
    rp, pp = _params(ref_cfg)
    xj, x = _x(1, (2, 8, cfg.d_model), 0.5)
    y = moe.moe_apply(cfg, pp, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y, ref_moe.moe_apply(ref_cfg, rp, xj), F32)
    # and tests/test_moe.py's naive per-token loop, on the port's tensors
    from test_moe import _naive
    np.testing.assert_allclose(y.numpy(), _naive(cfg, pp, x.numpy()),
                               rtol=2e-4, atol=2e-4)


def test_capacity_drops_are_the_references():
    """cf 0.25: capacity 8 for 64 entries over 8 experts, so entries drop;
    the port drops the same ones (a different drop moves whole expert
    outputs, far past the bound) and stays finite."""
    ref_cfg, cfg = _cfgs(cf=0.25)
    assert moe._capacity(32, cfg.moe) == 8
    rp, pp = _params(ref_cfg)
    xj, x = _x(2, (2, 16, cfg.d_model), 1.0)
    y = moe.moe_apply(cfg, pp, x)
    assert bool(torch.isfinite(y).all())
    want = ref_moe.moe_apply(ref_cfg, rp, xj)
    _close(y, want, F32)
    # drops happened: the unbounded layer differs
    full = moe.moe_apply(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=32.0)), pp, x)
    assert float((full - y).abs().max()) > 1e-3


def test_shared_expert_always_on():
    ref_cfg, cfg = _cfgs(n_shared=1)
    rp, pp = _params(ref_cfg)
    xj, x = _x(3, (1, 4, cfg.d_model), 0.1)
    y_full = moe.moe_apply(cfg, pp, x)
    _close(y_full, ref_moe.moe_apply(ref_cfg, rp, xj), F32)
    # zero the routed experts: only the shared path remains
    p0 = dict(pp, w_down=torch.zeros_like(pp["w_down"]))
    rp0 = dict(rp, w_down=jnp.zeros_like(rp["w_down"]))
    y_shared = moe.moe_apply(cfg, p0, x)
    _close(y_shared, ref_moe.moe_apply(ref_cfg, rp0, xj), F32)
    np.testing.assert_allclose(
        y_shared.numpy(),
        layers.swiglu_apply(pp["shared"], x.reshape(4, -1)).reshape(
            1, 4, -1).numpy(), rtol=1e-5, atol=1e-6)
    _close(layers.swiglu_apply(pp["shared"], x.reshape(4, -1)),
           ref_layers.swiglu_apply(rp["shared"], xj.reshape(4, -1)), F32)
    assert float((y_full - y_shared).abs().max()) > 0.0


def test_gate_weights_normalized():
    """Every expert the same: the output is the one expert's, whatever
    the routing, as the gates sum to 1 (cf high)."""
    ref_cfg, cfg = _cfgs(cf=32.0)
    rp, pp = _params(ref_cfg)
    pe = dict(pp, **{k: pp[k][:1].expand_as(pp[k]).contiguous()
                     for k in ("w_gate", "w_up", "w_down")})
    rpe = dict(rp, **{k: jnp.broadcast_to(rp[k][:1], rp[k].shape)
                      for k in ("w_gate", "w_up", "w_down")})
    xj, x = _x(4, (1, 8, cfg.d_model), 0.3)
    y = moe.moe_apply(cfg, pe, x)
    _close(y, ref_moe.moe_apply(ref_cfg, rpe, xj), F32)
    xf = x.reshape(-1, cfg.d_model)
    h = torch.nn.functional.silu(xf @ pe["w_gate"][0]) * (xf @ pe["w_up"][0])
    np.testing.assert_allclose(y.numpy(), (h @ pe["w_down"][0]).reshape(
        1, 8, -1).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("E,K", [(8, 2), (16, 2), (128, 8), (160, 6)])
def test_capacity_is_the_references(E, K):
    for T in (1, 2, 4, 7, 16, 128, 512, 4096):
        for cf in (0.25, 1.0, 1.25, 2.0, 32.0):
            ref_cfg, cfg = _cfgs(E=E, K=K, cf=cf)
            got = moe._capacity(T, cfg.moe)
            assert got == ref_moe._capacity(T, ref_cfg.moe), (T, cf)
            assert got % 8 == 0 and got >= 8


def test_tied_router_picks_the_references_experts():
    """Two identical router columns for every expert pair: every token's
    probabilities tie pairwise, and the reference's ``lax.top_k`` takes
    the lower id of a tie first.  The port routes the same (its stable
    descending sort), and so its output equals the reference's."""
    ref_cfg, cfg = _cfgs(E=8, K=3, cf=32.0)
    rp, pp = _params(ref_cfg)
    cols = np.asarray(rp["router"])[:, :4]
    tied = np.repeat(cols, 2, axis=1)               # columns 2i, 2i+1 equal
    rp = dict(rp, router=jnp.asarray(tied))
    pp = dict(pp, router=torch.as_tensor(tied.copy()))
    xj, x = _x(5, (2, 8, cfg.d_model), 0.5)
    probs = jax.nn.softmax(xj.reshape(-1, cfg.d_model) @ rp["router"], -1)
    want = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    _, gates, eids = moe.route(cfg, pp["router"], x.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(eids.numpy(), want)
    # each token's pair of tied experts comes lower id first
    assert (want[:, 0] % 2 == 0).all() and (want[:, 1] == want[:, 0] + 1).all()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    _close(moe.moe_apply(cfg, pp, x), ref_moe.moe_apply(ref_cfg, rp, xj),
           F32)


def test_bfloat16_routes_and_output_are_the_references():
    """bfloat16 on the same input: the router's logits, rounded to bf16
    before the float32 softmax, choose the reference's experts; the
    output is within the bf16 bound."""
    ref_cfg, cfg = _cfgs(E=8, K=2, cf=1.25)
    rp, pp = _params(ref_cfg, dtype=jnp.bfloat16)
    xj, _ = _x(6, (2, 16, cfg.d_model), 1.0)
    xj = xj.astype(jnp.bfloat16)
    x = torch.as_tensor(np.asarray(xj, np.float32)).bfloat16()   # exact
    probs = jax.nn.softmax(
        (xj.reshape(-1, cfg.d_model) @ rp["router"]).astype(jnp.float32), -1)
    want = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    got_p, _, eids = moe.route(cfg, pp["router"], x.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(eids.numpy(), want)
    _close(got_p, probs, F32)
    y = moe.moe_apply(cfg, pp, x)
    assert y.dtype == torch.bfloat16
    _close(y, ref_moe.moe_apply(ref_cfg, rp, xj).astype(jnp.float32), BF16)


def test_bfloat16_silu_within_two_ulps_of_the_references():
    """Why bfloat16 parity is a bound, not bit equality (ROADMAP C): the
    reference's bf16 ``silu`` on the CPU (XLA's logistic) and the port's
    (``F.silu``, rounded once from float32) differ by at most two bf16
    ulps, in a share of the elements; a MoE router downstream of them can
    flip a route where two experts' probabilities nearly tie."""
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32), np.float64)
    got = torch.nn.functional.silu(torch.as_tensor(x).bfloat16()).double()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got.numpy() - want)
    assert (diff <= 2 * ulp).all(), float((diff / ulp).max())
    assert 0.0 < float((diff > 0).mean()) < 0.5
