"""The port's model zoo against the JAX reference, on the CPU.

Configs and shapes: the ten architectures' full and smoke configs equal
the reference's field for field; for every full config the abstract
parameter and cache trees have the reference's key paths and shapes, and
``count_params`` is the same integer (with and without ``active_only``).

Numerics: parameters are drawn by the reference's ``init_tree(PRNGKey(0))``
and carried across (``interop.params_from_numpy``).  For every smoke
config (the GQA decoders, the MoE, SSM and hybrid ones, DeepSeek-V2's
MLA, Whisper's encoder-decoder on frames drawn as 0.1·N(0, 1)) the port's
``forward`` logits, and its ``prefill`` plus two ``decode_step`` logits
and caches (Whisper's cross cache included), agree with the reference's
within 2e-5 * (max|ref| + 1) in float32; each is also held to its own
forward at tests/test_models.py's tolerances (MoE at capacity factor 32,
as there, so that no entry drops).  In bfloat16 at the configs' own
capacity, every cache leaf's path, dtype and value after prefill and
after each decode step is the reference's, the SSM state turning float32
at the first step.  The layers (``rmsnorm``, ``l2norm``, ``rope``,
``flash_attention`` over causal, q_offset, block size, group size and
dtype, ``decode_attention``, ``gelu_mlp_apply``) agree with the
reference's in float32 (same bound) and bfloat16 (8e-2 relative, the
kernels' bf16 tolerance).  ``init_tree`` keeps the reference's rule.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import layers, model, sharding  # noqa: E402

torch.set_num_threads(1)

RULES = ref_sharding.Rules(batch=("data",), fsdp=None, tensor=None,
                           seq_sp=None, kv_seq=None)
SERVED = ["tinyllama-1.1b", "qwen3-4b", "deepseek-7b", "deepseek-coder-33b",
          "pixtral-12b", "qwen3-moe-30b-a3b", "mamba2-130m", "jamba-v0.1-52b",
          "deepseek-v2-236b", "whisper-tiny"]
F32 = 2e-5          # x (max|ref| + 1), float32, port against reference
BF16 = 8e-2         # x (max|ref| + 1), bfloat16


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * (np.max(np.abs(want)) + 1.0), err


def _paths(tree, prefix=()):
    """{key path: leaf} of a nested dict/list tree (ParamSpec leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(cfg):
    return ref_sharding.init_tree(ref_model.model_abstract(cfg),
                                  jax.random.PRNGKey(0), jnp.float32)


def _ref_batch(cfg, B, S, seed=1):
    k = jax.random.PRNGKey(seed)
    batch = {"tokens": jax.random.randint(k, (B, S), 0, cfg.vocab_size)}
    if cfg.frontend == "vision":
        batch["patches"] = 0.02 * jax.random.normal(
            k, (B, cfg.num_patches, cfg.d_model), jnp.float32)
    if cfg.frontend == "audio":
        batch["frames"] = 0.1 * jax.random.normal(
            k, (B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    return batch


def _port_batch(batch):
    return {k: (torch.as_tensor(np.array(v)).long() if k == "tokens"
                else torch.as_tensor(np.array(v))) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------


def test_archs_are_the_references():
    assert configs.ARCHS == ref_configs.ARCHS
    with pytest.raises(KeyError):
        configs.get("gpt-5")


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_equal_the_references(arch):
    for get, ref_get in ((configs.get, ref_configs.get),
                         (configs.get_smoke, ref_configs.get_smoke)):
        cfg, ref = get(arch), ref_get(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        for prop in ("padded_vocab", "pattern", "is_encoder_decoder",
                     "attention_free", "supports_long_decode"):
            assert getattr(cfg, prop) == getattr(ref, prop), prop
        assert [cfg.is_moe_layer(i) for i in range(cfg.n_layers)] == [
            ref.is_moe_layer(i) for i in range(ref.n_layers)]


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_full_config_shapes_and_counts(arch):
    cfg, ref = configs.get(arch), ref_configs.get(arch)
    got = _paths(model.model_abstract(cfg))
    want = _paths(ref_model.model_abstract(ref))
    assert {p: (s.shape, s.logical, s.init) for p, s in got.items()} == {
        p: (s.shape, s.logical, s.init) for p, s in want.items()}
    got_c = _paths(model.cache_abstract(cfg, 2, 64))
    want_c = _paths(ref_model.cache_abstract(ref, 2, 64))
    assert {p: s.shape for p, s in got_c.items()} == {
        p: s.shape for p, s in want_c.items()}
    for active in (False, True):
        n = model.count_params(cfg, active_only=active)
        assert isinstance(n, int)
        assert n == ref_model.count_params(ref, active_only=active)
        assert model.non_embedding_params(cfg, active) == \
            ref_model.non_embedding_params(ref, active)
    assert cfg.param_count() == ref.param_count()


def test_init_tree_keeps_the_reference_rule():
    abstract = {
        "embed": sharding.ParamSpec((4096, 64), ("tensor", "fsdp")),
        "w": [sharding.ParamSpec((3, 512, 128), (None, "fsdp", "tensor"),
                                 scale=2.0)],
        "vec": sharding.ParamSpec((8192,), (None,)),
        "one": sharding.ParamSpec((7,), (None,), init="ones"),
        "zero": sharding.ParamSpec((5, 3), (None, None), init="zeros"),
    }
    for dtype in (torch.float32, torch.bfloat16):
        p = sharding.init_tree(abstract, torch.Generator().manual_seed(0),
                               dtype, "cpu")
        assert p["w"][0].shape == (3, 512, 128)
        assert all(t.dtype == dtype and t.device.type == "cpu"
                   for t in sharding.tree_leaves(p, is_leaf=lambda x: False))
        assert torch.equal(p["one"], torch.ones(7, dtype=dtype))
        assert torch.equal(p["zero"], torch.zeros(5, 3, dtype=dtype))
        for leaf, std in ((p["embed"], 1 / 4096 ** 0.5),
                          (p["w"][0], 2.0 / 512 ** 0.5),
                          (p["vec"], 1 / 8192 ** 0.5)):
            got = float(leaf.double().std())
            assert abs(got / std - 1) < 0.05, (got, std)
            assert abs(float(leaf.double().mean())) < 0.05 * std
    # a seed decides it; a model's tree comes out whole
    cfg = configs.get_smoke("tinyllama-1.1b")
    a = sharding.init_tree(model.model_abstract(cfg),
                           torch.Generator().manual_seed(3), torch.float32,
                           "cpu")
    b = sharding.init_tree(model.model_abstract(cfg),
                           torch.Generator().manual_seed(3), torch.float32,
                           "cpu")
    leaves_a = sharding.tree_leaves(a, is_leaf=lambda x: False)
    assert all(torch.equal(x, y) for x, y in zip(
        leaves_a, sharding.tree_leaves(b, is_leaf=lambda x: False)))
    shapes = {p: s.shape for p, s in _paths(model.model_abstract(cfg)).items()}
    assert {p: tuple(t.shape) for p, t in _paths(a).items()} == shapes
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert sharding.constrain(a["embed"], sharding.Rules(), "batch") is \
        a["embed"]


def test_init_tree_scales_in_place_to_the_same_bits():
    """Each normal leaf is scaled in place (no second copy of a stacked
    expert bank): the bits of ``randn * std`` from the same generator."""
    abstract = {"a": sharding.ParamSpec((3, 64, 48), (None, None, None)),
                "b": sharding.ParamSpec((96,), (None,), scale=0.5),
                "c": sharding.ParamSpec((5, 7), (None, None), init="ones")}
    for dtype in (torch.float32, torch.bfloat16):
        got = sharding.init_tree(abstract, torch.Generator().manual_seed(4),
                                 dtype, "cpu")
        gen = torch.Generator().manual_seed(4)
        for key, std in (("a", 1 / 64 ** 0.5), ("b", 0.5 / 96 ** 0.5)):
            x = torch.randn(abstract[key].shape, generator=gen, dtype=dtype)
            assert got[key].dtype == dtype
            assert torch.equal(got[key], x * std), key
        assert torch.equal(got["c"], torch.ones(5, 7, dtype=dtype))


def test_init_tree_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.init_tree({"w": sharding.ParamSpec((2, 2), (None, None))},
                           torch.Generator(), torch.float32)


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------


def _no_drops(cfg):
    """A MoE config at capacity factor 32 (tests/test_models.py's setting
    for decode ≡ forward: no entry drops); any other config as it is."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0))


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_decode_match_the_reference(arch):
    ref_cfg = _no_drops(ref_configs.get_smoke(arch))
    cfg = _no_drops(configs.get_smoke(arch))
    rp = _ref_params(ref_cfg)
    pp = interop.params_from_numpy(_np(rp), device="cpu")
    B, S = 2, 16
    rb = _ref_batch(ref_cfg, B, S)
    pb = _port_batch(rb)

    full_ref = np.asarray(ref_model.forward(ref_cfg, rp, rb, rules=RULES))
    full = model.forward(cfg, pp, pb)
    assert full.shape == (B, S, cfg.padded_vocab)
    _close(full, full_ref, F32)

    ref_cache = ref_model.init_cache(ref_cfg, B, 32, jnp.float32)
    cache = model.init_cache(cfg, B, 32, torch.float32, device="cpu")
    rl, ref_cache = ref_model.prefill(
        ref_cfg, rp, dict(rb, tokens=rb["tokens"][:, :S - 2]), ref_cache,
        rules=RULES)
    pl, cache = model.prefill(cfg, pp, dict(pb, tokens=pb["tokens"][:, :S - 2]),
                              cache)
    _close(pl, rl, F32)
    if cfg.frontend != "vision":     # prefill reads no patches
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, S - 3].numpy(),
                                   rtol=1e-4, atol=1e-4)
    pos = S - 2
    for _ in range(2):
        rd, ref_cache = ref_model.decode_step(
            ref_cfg, rp, rb["tokens"][:, pos:pos + 1], ref_cache,
            jnp.asarray(pos, jnp.int32), rules=RULES)
        pd, cache = model.decode_step(cfg, pp, pb["tokens"][:, pos:pos + 1],
                                      cache, pos)
        _close(pd, rd, F32)
        if cfg.frontend != "vision":
            np.testing.assert_allclose(pd[:, 0].numpy(), full[:, pos].numpy(),
                                       rtol=1e-4, atol=2e-4)
        pos += 1
    got, want = _paths(cache), _paths(_np(ref_cache))
    assert got.keys() == want.keys()
    for p in want:
        _close(got[p], want[p], F32)


def test_vision_patches_prefix_the_sequence():
    """pixtral: the patches move the logits (they are attended), and a
    zero-patch forward is not the patch-free one (positions shift)."""
    cfg = configs.get_smoke("pixtral-12b")
    pp = interop.params_from_numpy(_np(_ref_params(
        ref_configs.get_smoke("pixtral-12b"))), device="cpu")
    pb = _port_batch(_ref_batch(cfg, 2, 8))
    with_p = model.forward(cfg, pp, pb)
    without = model.forward(cfg, pp, {"tokens": pb["tokens"]})
    assert with_p.shape == without.shape == (2, 8, cfg.padded_vocab)
    assert float((with_p - without).abs().max()) > 1e-4


def test_cache_write_past_the_end_raises():
    cfg = configs.get_smoke("tinyllama-1.1b")
    pp = sharding.init_tree(model.model_abstract(cfg),
                            torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
    cache = model.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    model.decode_step(cfg, pp, tok, cache, 3)
    with pytest.raises(ValueError, match="outside"):
        model.decode_step(cfg, pp, tok, cache, 4)


def test_latent_cache_write_past_the_end_raises():
    """MLA's (ckv, krope) cache is written in place as GQA's is, and a
    write past its end raises as GQA's does."""
    cfg = configs.get_smoke("deepseek-v2-236b")
    pp = sharding.init_tree(model.model_abstract(cfg),
                            torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
    cache = model.init_cache(cfg, 1, 4, device="cpu")
    ckv = cache["prefix"][0]["attn"]["ckv"]
    tok = torch.zeros((1, 1), dtype=torch.int64)
    _, out = model.decode_step(cfg, pp, tok, cache, 3)
    assert out["prefix"][0]["attn"]["ckv"] is ckv
    assert float(ckv[:, 3].abs().max()) > 0 and not ckv[:, :3].any()
    with pytest.raises(ValueError, match="outside"):
        model.decode_step(cfg, pp, tok, cache, 4)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-130m",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_bfloat16_caches_match_the_reference(arch):
    """bfloat16 at the config's own capacity factor: after prefill and
    after each of two decode steps, the cache tree has the reference's key
    paths, dtypes and values (8e-2 of max + 1), the logits too.  The SSM
    state leaf is bfloat16 after prefill and float32 from the first decode
    step on, in the tree the caller passed, as the reference's scan hands
    it back; Whisper's cross cache holds the projections in their dtype.
    (DeepSeek-V2 is not among them: the reference's absorbed MLA decode
    cannot run in bfloat16 on the CPU, XLA refusing its bf16 x bf16 ->
    f32 products; its latent cache keeps its dtype.)"""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke(arch),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    rp = ref_sharding.init_tree(ref_model.model_abstract(ref_cfg),
                                jax.random.PRNGKey(0), jnp.bfloat16)
    pp = interop.params_from_numpy(_np(rp), device="cpu")
    B, S = 2, 16
    rb = _ref_batch(ref_cfg, B, S)
    pb = _port_batch(rb)
    ref_cache = ref_model.init_cache(ref_cfg, B, 32)
    cache = model.init_cache(cfg, B, 32, device="cpu")
    callers = cache["slots"]

    def same(got_cache, want_cache):
        got, want = _paths(got_cache), _paths(_np(want_cache))
        assert got.keys() == want.keys()
        for p in want:
            assert str(got[p].dtype)[6:] == str(want[p].dtype), p
            _close(got[p], want[p].astype(np.float32), BF16)
        return {p: got[p].dtype for p in got if p[-1] == "state"}

    rl, ref_cache = ref_model.prefill(
        ref_cfg, rp, dict(rb, tokens=rb["tokens"][:, :S - 2]), ref_cache,
        rules=RULES)
    pl, cache = model.prefill(cfg, pp, dict(pb, tokens=pb["tokens"][:, :S - 2]),
                              cache)
    _close(pl, np.asarray(rl.astype(jnp.float32)), BF16)
    states = same(cache, ref_cache)
    assert set(states.values()) <= {torch.bfloat16}
    assert bool(states) == (cfg.ssm is not None)
    for pos in (S - 2, S - 1):
        rd, ref_cache = ref_model.decode_step(
            ref_cfg, rp, rb["tokens"][:, pos:pos + 1], ref_cache,
            jnp.asarray(pos, jnp.int32), rules=RULES)
        pd, cache = model.decode_step(cfg, pp, pb["tokens"][:, pos:pos + 1],
                                      cache, pos)
        _close(pd, np.asarray(rd.astype(jnp.float32)), BF16)
        states = same(cache, ref_cache)
        assert set(states.values()) <= {torch.float32}
    assert cache["slots"] is callers    # the caller's tree, updated


# ---------------------------------------------------------------------------
# layers against the reference
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32, F32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _pair(rng, shape, dtype, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    return torch.as_tensor(a).to(tdt), jnp.asarray(a, jdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_norms_and_rope_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    tol = DTYPES[dtype][2]
    x, xj = _pair(rng, (2, 5, 3, 16), dtype, 3.0)
    sc, scj = _pair(rng, (16,), dtype)
    _close(layers.rmsnorm({"scale": sc}, x, 1e-6),
           ref_layers.rmsnorm({"scale": scj}, xj, 1e-6).astype(jnp.float32),
           tol)
    _close(layers.l2norm(x, 1e-6),
           ref_layers.l2norm(xj, 1e-6).astype(jnp.float32), tol)
    assert layers.rmsnorm({"scale": sc}, x, 1e-6).dtype == x.dtype
    # the learned qk-norm scale multiplies after the cast back
    _close(layers.l2norm(x, 1e-6) * sc,
           (ref_layers.l2norm(xj, 1e-6) * scj).astype(jnp.float32), tol)
    for theta in (10000.0, 1e6):
        pos = np.arange(3, 8)
        got = layers.rope(x, torch.as_tensor(pos), theta)
        want = ref_layers.rope(xj, jnp.asarray(pos), theta)
        assert got.dtype == x.dtype
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("q_offset", [0, 4, 14])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_the_reference(causal, q_offset, blk, G,
                                               dtype):
    rng = np.random.default_rng(q_offset + 10 * blk + G)
    B, Sq, Sk, K, d = 2, 8, 32, 2, 16
    H = K * G
    q, qj = _pair(rng, (B, Sq, H, d), dtype)
    k, kj = _pair(rng, (B, Sk, K, d), dtype)
    v, vj = _pair(rng, (B, Sk, K, d), dtype)
    got = layers.flash_attention(q, k, v, q_offset, causal, blk)
    want = ref_layers.flash_attention(qj, kj, vj, q_offset, causal, blk)
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, d)
    _close(got, want.astype(jnp.float32), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 2])
def test_decode_attention_matches_the_reference(G, dtype):
    rng = np.random.default_rng(G)
    B, Sk, K, d = 2, 24, 2, 16
    q, qj = _pair(rng, (B, 1, K * G, d), dtype)
    k, kj = _pair(rng, (B, Sk, K, d), dtype)
    v, vj = _pair(rng, (B, Sk, K, d), dtype)
    for kv_len in (1, 9, Sk):
        got = layers.decode_attention(q, k, v, kv_len=kv_len)
        want = ref_layers.decode_attention(qj, kj, vj, kv_len=kv_len)
        _close(got, want.astype(jnp.float32), DTYPES[dtype][2])


def test_flash_q_offset_masks_future():
    """With q_offset = t, query i attends keys <= t + i only (the twin of
    tests/test_sharding_rules.py's case)."""
    rng = np.random.default_rng(0)
    B, S, H, d = 1, 16, 2, 8
    q = torch.as_tensor(rng.standard_normal((B, 2, H, d)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, S, H, d)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, H, d)), dtype=torch.float32)
    out1 = layers.flash_attention(q, k, v, 4, True, 8)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:] = 0.0
    v2[:, 6:] = 0.0
    out2 = layers.flash_attention(q, k2, v2, 4, True, 8)
    np.testing.assert_allclose(out1[:, 1].numpy(), out2[:, 1].numpy(),
                               rtol=1e-5, atol=1e-6)
    out3 = layers.flash_attention(q, k, v, 14, True, 8)
    out4 = layers.flash_attention(q, k2, v2, 14, True, 8)
    assert float((out3 - out4).abs().max()) > 1e-4


def test_gelu_mlp_matches_the_reference_tanh_form():
    """``jax.nn.gelu``'s default is the tanh approximation: the port's
    GELU MLP agrees with the reference's within 2e-5 of max + 1, where the
    exact erf form on the same pre-activations (spread over [-4, 4],
    through |x| near 2.7) would not."""
    rng = np.random.default_rng(0)
    D, Fd = 8, 64
    x, xj = _pair(rng, (3, 5, D), "float32")
    w_in = rng.standard_normal((D, Fd)).astype(np.float32)
    w_in *= 2.0 / np.abs(x.numpy().reshape(-1, D) @ w_in).max() * 2.0
    p = {"w_in": w_in, "b_in": rng.standard_normal(Fd).astype(np.float32),
         "w_out": rng.standard_normal((Fd, D)).astype(np.float32),
         "b_out": rng.standard_normal(D).astype(np.float32)}
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    want = np.asarray(ref_layers.gelu_mlp_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, xj))
    _close(layers.gelu_mlp_apply(pt, x), want, F32)
    erf = torch.nn.functional.gelu(x @ pt["w_in"] + pt["b_in"]) \
        @ pt["w_out"] + pt["b_out"]
    err = float(np.abs(erf.numpy() - want).max())
    assert err > F32 * (np.abs(want).max() + 1.0), err


def test_pick_blk_is_the_references():
    for sk in (64, 62, 96, 128, 4096, 12288, 7, 1):
        assert layers.pick_blk(sk) == ref_layers.pick_blk(sk), sk
