"""The port's LM serving entry point and APC probe head against the JAX
reference, on the CPU.

Serving: on parameters drawn by the reference's ``init_tree`` and carried
across, ``generate_batch`` emits the reference's greedy tokens, twice the
same, for the GQA, MoE, SSM, hybrid, MLA and encoder-decoder smoke
configs (Whisper on frames drawn as 0.1·N(0, 1)); the decode step built
by ``make_decode`` is the one every step goes through; ``main`` serves
each with ``--device cpu`` (``serve`` the same tokens on a config
object; Whisper on the reference CLI's zero frames), and refuses to
start without a card otherwise.

Probe: ``fit_probe`` on tests/test_system.py's ridge inputs gives the
reference's w within 1e-9 relative (float64 APC on both sides), m reduced
until it divides n as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.optim import apc_head as ref_head  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model, sharding  # noqa: E402
from repro_torch.optim import apc_head  # noqa: E402
from repro_torch.solvers import serve as linsys_serve  # noqa: E402

torch.set_num_threads(1)

RULES = ref_sharding.Rules(batch=("data",), fsdp=None, tensor=None,
                           seq_sp=None, kv_seq=None)


NEW_FAMILIES = ["qwen3-moe-30b-a3b", "mamba2-130m", "jamba-v0.1-52b",
                "deepseek-v2-236b", "whisper-tiny"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b",
                                  "pixtral-12b"] + NEW_FAMILIES)
def test_generate_batch_tokens_equal_the_references(arch):
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    rp = ref_sharding.init_tree(ref_model.model_abstract(ref_cfg),
                                jax.random.PRNGKey(0), jnp.float32)
    pp = interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                   device="cpu")
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                          ref_cfg.vocab_size))
    extra, ref_extra = None, None
    if cfg.frontend == "audio":
        frames = 0.1 * np.random.default_rng(2).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        extra = {"frames": torch.as_tensor(frames)}
        ref_extra = {"frames": jnp.asarray(frames)}
    want = np.asarray(ref_serve.generate_batch(
        ref_cfg, rp, jnp.asarray(prompts), 6, RULES, ref_extra))
    calls = []
    decode = serve.make_decode(cfg)

    def counted(*a):
        calls.append(a[3])
        return decode(*a)
    runs = [serve.generate_batch(cfg, pp, torch.as_tensor(prompts).long(), 6,
                                 extra=extra, decode=counted)
            for _ in range(2)]
    assert runs[0].shape == (2, 6) and runs[0].dtype == torch.int64
    np.testing.assert_array_equal(runs[0].numpy(), want)
    assert torch.equal(runs[0], runs[1])
    # the one decode step, at cache lengths S .. S + max_new - 1
    assert calls == list(range(8, 14)) * 2


def test_serve_main_on_the_cpu(capsys):
    assert serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(x.startswith("batch of 2 (+0 pad): generated 8 tokens each")
               for x in out) == 3
    assert out[-1].startswith("served 6 requests in ")
    rep = serve.run(["--arch", "pixtral-12b", "--smoke", "--requests", "3",
                     "--batch", "2", "--prompt-len", "5", "--max-new", "3",
                     "--device", "cpu"])
    assert rep.served == 3 and len(rep.tokens) == 2
    assert rep.tokens[0].shape == (2, 3)
    assert serve.take_group is linsys_serve.take_group
    # the encoder-decoder serves too, on the reference CLI's zero frames
    rep = serve.run(["--arch", "whisper-tiny", "--smoke", "--requests", "3",
                     "--batch", "2", "--prompt-len", "5", "--max-new", "3",
                     "--device", "cpu"])
    assert rep.served == 3 and [t.shape for t in rep.tokens] == [(2, 3),
                                                                 (2, 3)]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_main_serves_the_new_families_on_the_cpu(arch, capsys):
    """The CLI serves each MoE, SSM, hybrid, MLA and encoder-decoder
    smoke config, twice the same tokens; ``serve`` on the same config and
    parameters (the path a depth cut takes) emits them too."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    reps = [serve.run(argv) for _ in range(2)]
    out = capsys.readouterr().out.splitlines()
    assert sum(x.startswith("served 3 requests in ") for x in out) == 2
    assert reps[0].served == 3 and [t.shape for t in reps[0].tokens] == [
        (2, 4), (2, 4)]
    for a, b in zip(reps[0].tokens, reps[1].tokens):
        np.testing.assert_array_equal(a, b)
    cfg = configs.get_smoke(arch)
    params = sharding.init_tree(model.model_abstract(cfg),
                                torch.Generator().manual_seed(0),
                                model.cache_dtype(cfg), "cpu")
    rep = serve.serve(cfg, params, requests=3, batch=2, prompt_len=8,
                      max_new=4, device=torch.device("cpu"))
    for a, b in zip(rep.tokens, reps[0].tokens):
        np.testing.assert_array_equal(a, b)


def test_serve_main_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke"])


def _ridge(T, n, seed=0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((T, n))
    w_true = rng.standard_normal(n)
    return H, H @ w_true + 0.01 * rng.standard_normal(T)


@pytest.mark.parametrize("T,n,m,lam,iters", [(256, 32, 4, 1e-2, 400),
                                             (128, 30, 8, 1e-1, 300)])
def test_fit_probe_matches_the_reference(T, n, m, lam, iters):
    H, y = _ridge(T, n)
    w_ref, res_ref = ref_head.fit_probe(jnp.asarray(H), jnp.asarray(y), m=m,
                                        lam=lam, iters=iters)
    w, res = apc_head.fit_probe(H, y, m=m, lam=lam, iters=iters,
                                device="cpu")
    assert w.dtype == torch.float64 and res.shape == (iters,)
    w_ref = np.asarray(w_ref)
    assert np.linalg.norm(w.numpy() - w_ref) <= 1e-9 * np.linalg.norm(w_ref)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-9)
    A, b = apc_head.normal_system(torch.as_tensor(H), torch.as_tensor(y), lam)
    A_ref, b_ref = ref_head.normal_system(jnp.asarray(H), jnp.asarray(y), lam)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-12)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-12)
    # the closed form, as tests/test_system.py holds the reference
    np.testing.assert_allclose(w.numpy(), np.linalg.solve(A.numpy(),
                                                          b.numpy()),
                               rtol=1e-6, atol=1e-8)
    assert apc_head.probe_loss(torch.as_tensor(H), torch.as_tensor(y), w) == \
        pytest.approx(ref_head.probe_loss(jnp.asarray(H), jnp.asarray(y),
                                          jnp.asarray(w.numpy())), rel=1e-12)


def test_params_and_caches_cross_by_key_path():
    cfg = ref_configs.get_smoke("qwen3-4b")
    rp = jax.tree.map(np.asarray, ref_sharding.init_tree(
        ref_model.model_abstract(cfg), jax.random.PRNGKey(0), jnp.bfloat16))
    pp = interop.params_from_numpy(rp, device="cpu")
    assert pp["decoder"]["slots"][0]["attn"]["q_norm"].dtype == torch.bfloat16
    want = rp["decoder"]["slots"][0]["attn"]["wq"]
    got = pp["decoder"]["slots"][0]["attn"]["wq"]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    rc = jax.tree.map(np.asarray, ref_model.init_cache(cfg, 2, 8,
                                                       jnp.float32))
    pc = interop.cache_from_numpy(rc, device="cpu")
    assert [tuple(t.shape) for t in sharding.tree_leaves(
        pc, is_leaf=lambda x: False)] == [a.shape for a in
                                          jax.tree.leaves(rc)]
    assert model.cache_abstract(configs.get_smoke("qwen3-4b"), 2, 8)[
        "slots"][0]["attn"]["k"].shape == pc["slots"][0]["attn"]["k"].shape
