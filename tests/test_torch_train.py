"""The port's LM training path against the JAX reference, on the CPU.

``flash_attention``'s block-recompute backward (a
``torch.autograd.Function``) gives ``jax.vjp`` of the reference's custom
VJP over the forward's grid (causal, q_offset, block size, group size)
within 2e-5 (float32) and 8e-2 (bfloat16) of max|ref| + 1, also with the
query rows split into chunks, and plain autograd through its own forward
loop within the same bounds.  On
parameters drawn by the reference's ``init_tree(PRNGKey(0))`` and carried
across, for each of the ten smoke configs (the twin of
tests/test_models.py's ``test_smoke_forward_and_train_step``) the loss is
the reference's within 2e-5 * (|loss| + 1), every gradient leaf within
1e-4 * max|g_ref| of the reference's, and one AdamW update on the
reference's gradients within 1e-6 of the reference's update.  The
vocab-pad columns are masked; a period recomputed in the backward
(``torch.utils.checkpoint``) gives the plain gradients bit for bit.  The
train CLI (``launch.train``) on the CPU tracks the reference's loop over
three steps within 1e-4 relative, checkpoints and resumes (the twin of
tests/test_system.py's ``test_train_driver_checkpoints_and_resumes``,
in-process), resumes exactly, and refuses a missing card (its mesh
runs are in tests/test_torch_sharding.py).
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, model, sharding, transformer  # noqa: E402,E501
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)

RULES = ref_sharding.Rules(batch=("data",), fsdp=None, tensor=None,
                           seq_sp=None, kv_seq=None)
F32 = 2e-5          # x (max|ref| + 1), float32
BF16 = 8e-2         # x (max|ref| + 1), bfloat16
GRAD = 1e-4         # x max|g_ref| of the leaf
UPDATE = 1e-6       # AdamW on carried gradients, absolute
TRAIN_REL = 1e-4    # the CLI's losses against the reference's loop
LEAF = lambda x: False  # noqa: E731


def _close(got, want, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * (np.max(np.abs(want)) + 1.0), err


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(cfg_ref):
    """The reference's init_tree(PRNGKey(0)) parameters and the port's
    copy, every leaf requiring grad."""
    rp = ref_sharding.init_tree(ref_model.model_abstract(cfg_ref),
                                jax.random.PRNGKey(0), jnp.float32)
    pp = interop.params_from_numpy(_np(rp), device="cpu")
    for t in sharding.tree_leaves(pp, LEAF):
        t.requires_grad_()
    return rp, pp


def _batches(cfg, B, S, seed=1):
    """tests/test_models.py's batch (labels = tokens), the reference's and
    the port's."""
    k = jax.random.PRNGKey(seed)
    toks = jax.random.randint(k, (B, S), 0, cfg.vocab_size)
    rb = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        rb["patches"] = 0.02 * jax.random.normal(
            k, (B, cfg.num_patches, cfg.d_model), jnp.float32)
    if cfg.frontend == "audio":
        rb["frames"] = 0.1 * jax.random.normal(
            k, (B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    pb = {key: (torch.as_tensor(np.array(v)).long()
                if key in ("tokens", "labels")
                else torch.as_tensor(np.array(v))) for key, v in rb.items()}
    return rb, pb


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32, F32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    return torch.as_tensor(a).to(tdt).requires_grad_(), jnp.asarray(a, jdt)


def _flash_case(causal, q_offset, blk, G, dtype, seed):
    rng = np.random.default_rng(seed)
    B, Sq, Sk, K, d = 2, 8, 32, 2, 16
    H = K * G
    q, qj = _pair(rng, (B, Sq, H, d), dtype)
    k, kj = _pair(rng, (B, Sk, K, d), dtype)
    v, vj = _pair(rng, (B, Sk, K, d), dtype)
    do, doj = _pair(rng, (B, Sq, H, d), dtype)
    return (q, k, v, do), (qj, kj, vj, doj)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("q_offset", [0, 4, 14])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_the_reference_vjp(causal, q_offset, blk, G,
                                                  dtype):
    (q, k, v, do), (qj, kj, vj, doj) = _flash_case(
        causal, q_offset, blk, G, dtype, q_offset + 10 * blk + G)
    out = layers.flash_attention(q, k, v, q_offset, causal, blk)
    grads = torch.autograd.grad(out, (q, k, v), do)
    want_out, vjp = jax.vjp(lambda a, b, c: ref_layers.flash_attention(
        a, b, c, q_offset, causal, blk), qj, kj, vj)
    tol = DTYPES[dtype][2]
    _close(out, want_out.astype(jnp.float32), tol)
    for got, want, x in zip(grads, vjp(doj), (q, k, v)):
        assert got.dtype == x.dtype and got.shape == x.shape
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows", [1, 3, 4])
@pytest.mark.parametrize("causal,q_offset,blk,G", [(True, 0, 8, 2),
                                                   (True, 14, 16, 1),
                                                   (False, 4, 8, 2)])
def test_flash_query_chunks_match_the_reference_vjp(causal, q_offset, blk, G,
                                                    rows, dtype, monkeypatch):
    """A tile budget of ``rows`` query rows (3: a ragged last chunk) splits
    the forward and the backward into query chunks: the output and the
    gradients are still the reference's."""
    (q, k, v, do), (qj, kj, vj, doj) = _flash_case(
        causal, q_offset, blk, G, dtype, 40 + rows)
    B, Sq, H, _ = q.shape
    monkeypatch.setattr(layers, "TILE_BYTES", rows * B * H * blk * 4)
    assert layers._row_chunk(B, H, Sq, blk) == rows
    out = layers.flash_attention(q, k, v, q_offset, causal, blk)
    grads = torch.autograd.grad(out, (q, k, v), do)
    want_out, vjp = jax.vjp(lambda a, b, c: ref_layers.flash_attention(
        a, b, c, q_offset, causal, blk), qj, kj, vj)
    tol = DTYPES[dtype][2]
    _close(out, want_out.astype(jnp.float32), tol)
    for got, want in zip(grads, vjp(doj)):
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,q_offset,blk,G", [(True, 0, 8, 2),
                                                   (True, 14, 16, 1),
                                                   (False, 4, 8, 2)])
def test_flash_backward_matches_plain_autograd(causal, q_offset, blk, G,
                                               dtype):
    """The Function's gradients against autograd through its own forward
    loop (which keeps every probability tile)."""
    (q, k, v, do), _ = _flash_case(causal, q_offset, blk, G, dtype, 7)
    got = torch.autograd.grad(layers.flash_attention(
        q, k, v, q_offset, causal, blk), (q, k, v), do)
    out, _ = layers._flash_fwd(q, k, v, q_offset, causal, blk)
    assert out.grad_fn is not None
    want = torch.autograd.grad(out, (q, k, v), do)
    for a, b in zip(got, want):
        _close(a, b.float().numpy(), DTYPES[dtype][2])


def test_flash_saves_no_probability_tile():
    """The Function keeps (q, k, v, out, lse) for its backward, no
    (Sq x blk) tile; it runs under ``torch.inference_mode`` (serving) with
    the same result."""
    (q, k, v, _), _ = _flash_case(True, 0, 8, 2, "float32", 3)
    out = layers.flash_attention(q, k, v, 0, True, 8)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        tuple(q.shape), tuple(k.shape), tuple(v.shape), tuple(out.shape),
        (2, 2, 2, 8)]
    with torch.inference_mode():
        again = layers.flash_attention(q, k, v, 0, True, 8)
    assert torch.equal(again, out.detach())


# ---------------------------------------------------------------------------
# loss, gradients and one update per architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_loss_gradients_and_update_match_the_reference(arch):
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    rp, pp = _carried(ref_cfg)
    rb, pb = _batches(ref_cfg, 2, 32)
    acfg = adamw.AdamWConfig(lr=1e-3)

    @jax.jit
    def ref_step(p, b):
        loss, g = jax.value_and_grad(
            lambda pp: ref_model.loss_fn(ref_cfg, pp, b, rules=RULES))(p)
        return (loss, g) + ref_adamw.update(
            ref_adamw.AdamWConfig(lr=1e-3), g, ref_adamw.init(p), p)
    want_loss, want_g, want_p, want_st = ref_step(rp, rb)
    loss, grads = train.loss_and_grads(cfg, pp, pb)
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(want_loss)) <= F32 * (
        abs(float(want_loss)) + 1.0)
    got_l = sharding.tree_leaves(grads, LEAF)
    want_l = jax.tree.leaves(want_g)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= GRAD * np.abs(w).max()
    # one AdamW update on the reference's gradients, carried across
    new_p, st = adamw.update(acfg, interop.params_from_numpy(
        _np(want_g), device="cpu"), adamw.init(pp), pp)
    assert st.step == int(want_st.step) == 1
    moved = 0.0
    for a, w, p in zip(sharding.tree_leaves(new_p, LEAF),
                       jax.tree.leaves(want_p),
                       sharding.tree_leaves(pp, LEAF)):
        assert a.requires_grad and a.dtype == p.dtype
        assert float(np.abs(a.detach().numpy() - np.asarray(w)).max()) \
            <= UPDATE
        moved += float((a - p).detach().abs().sum())
    assert moved > 0.0


def test_vocab_padding_masked_in_loss():
    """The twin of tests/test_models.py's case: vocab 250 pads to 256, the
    pad columns are out of the softmax (loss and gradients as the
    reference's), and a label < 0 drops out of the mean."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke("tinyllama-1.1b"),
                                  vocab_size=250)
    cfg = dataclasses.replace(configs.get_smoke("tinyllama-1.1b"),
                              vocab_size=250)
    assert cfg.padded_vocab == 256
    rp, pp = _carried(ref_cfg)
    rb, pb = _batches(ref_cfg, 2, 16)
    labels = np.array(rb["labels"])
    labels[0, :5] = -1
    rb["labels"], pb["labels"] = jnp.asarray(labels), torch.as_tensor(
        labels).long()
    want, want_g = jax.value_and_grad(
        lambda p: ref_model.loss_fn(ref_cfg, p, rb, rules=RULES))(rp)
    loss, grads = train.loss_and_grads(cfg, pp, pb)
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(want)) <= F32 * (abs(float(want)) + 1)
    head = grads["lm_head"]
    assert not head[:, 250:].any()          # no gradient into the pad
    w = np.asarray(want_g["lm_head"])
    assert float(np.abs(head.numpy() - w).max()) <= GRAD * np.abs(w).max()
    # the masked labels leave the loss a mean over the other 27
    unmasked = dict(pb, labels=torch.where(pb["labels"] < 0, 0,
                                           pb["labels"]))
    with torch.no_grad():
        other = float(model.loss_fn(cfg, pp, unmasked))
    assert other != pytest.approx(float(loss))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "deepseek-v2-236b", "whisper-tiny"])
def test_recomputed_periods_give_the_plain_gradients(arch, monkeypatch):
    """``train=True`` runs each period under ``torch.utils.checkpoint``
    (none for Whisper, whose decoder has a cross stack, as the
    reference's remat); the gradients equal those with no recompute bit
    for bit."""
    cfg = configs.get_smoke(arch)
    _, pp = _carried(ref_configs.get_smoke(arch))
    _, pb = _batches(cfg, 2, 16)
    calls = []

    def counted(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return checkpoint(fn, *a, **kw)
    checkpoint = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint", counted)
    loss, grads = train.loss_and_grads(cfg, pp, pb)
    n_periods = (cfg.n_layers - len(pp["decoder"]["prefix"])) // len(
        cfg.pattern)
    assert calls == ([] if cfg.is_encoder_decoder
                     else [False] * n_periods), calls
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    loss2, grads2 = train.loss_and_grads(cfg, pp, pb)
    assert torch.equal(loss, loss2)
    for a, b in zip(sharding.tree_leaves(grads, LEAF),
                    sharding.tree_leaves(grads2, LEAF)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def _ref_losses(arch, steps, B, S):
    """The reference driver's loop (launch/train.py) for ``steps`` steps
    from its own parameters, jitted, on one device."""
    cfg = ref_configs.get_smoke(arch)
    params = ref_sharding.init_tree(ref_model.model_abstract(cfg),
                                    jax.random.PRNGKey(0), jnp.float32)
    opt = ref_adamw.init(params)
    acfg = ref_adamw.AdamWConfig(lr=1e-3)
    dcfg = ref_synthetic.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B)

    @jax.jit
    def step_fn(p, o, b, lr_s):
        loss, g = jax.value_and_grad(
            lambda pp: ref_model.loss_fn(cfg, pp, b, rules=RULES))(p)
        p2, o2 = ref_adamw.update(acfg, g, o, p, lr_scale=lr_s)
        return p2, o2, loss

    losses = []
    for step in range(steps):
        b = dict(ref_synthetic.make_batch(dcfg, step))
        if cfg.frontend == "audio":
            b["frames"] = jnp.zeros((B, cfg.encoder_seq, cfg.d_model))
        lr_s = ref_schedule.linear_warmup_cosine(
            jnp.asarray(step, jnp.float32), warmup=max(steps // 10, 1),
            total=steps)
        params, opt, loss = step_fn(params, opt, b, lr_s)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b",
                                  "whisper-tiny"])
def test_train_cli_tracks_the_reference_loop(arch, monkeypatch, capsys):
    """Three steps of ``launch.train --smoke --device cpu`` from the
    reference's parameters (carried into ``init_params``): each step's
    loss within 1e-4 relative of the reference loop's."""
    rp, want = _ref_losses(arch, 3, 2, 32)
    ref0 = ref_sharding.init_tree(
        ref_model.model_abstract(ref_configs.get_smoke(arch)),
        jax.random.PRNGKey(0), jnp.float32)
    made = []

    def carried(cfg, device, seed=0):
        made.append(seed)
        p = interop.params_from_numpy(_np(ref0), device=device)
        for t in sharding.tree_leaves(p, LEAF):
            t.requires_grad_()
        return p
    monkeypatch.setattr(train, "init_params", carried)
    rep = train.run(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                     "2", "--seq", "32", "--log-every", "1", "--device",
                     "cpu"])
    assert made == [0] and rep.start_step == 0 and len(rep.losses) == 3
    np.testing.assert_allclose(rep.losses, want, rtol=TRAIN_REL)
    out = capsys.readouterr().out.splitlines()
    assert [x.split()[:4] for x in out] == [
        ["step", str(s), "loss", f"{l:.4f}"] for s, l in enumerate(
            rep.losses)]


def test_train_driver_checkpoints_and_resumes(tmp_path, capsys):
    """tests/test_system.py's case in-process: six steps checkpointed
    every three, then a run to eight resumes from step 6."""
    d = str(tmp_path / "ck")
    args = ["--arch", "mamba2-130m", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "3",
            "--device", "cpu"]
    assert train.main(args) == 0
    assert "checkpoint" in capsys.readouterr().out
    args[args.index("6")] = "8"
    rep = train.run(args)
    out = capsys.readouterr().out
    assert "resumed from step 6" in out, out
    assert rep.start_step == 6 and len(rep.losses) == 2
    assert all(np.isfinite(rep.losses))


def test_train_resumes_exactly(tmp_path):
    """A run resumed from its step-3 checkpoint repeats steps 3-5 of the
    uninterrupted run bit for bit (the data are a function of the step,
    the optimizer state is in the checkpoint).  The error-feedback
    buffers of ``--compress-grads`` are not checkpointed, as the
    reference's are not: such a run restarts them at zero."""
    d = tmp_path / "ck"
    args = ["--arch", "qwen3-4b", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(d), "--ckpt-every", "3",
            "--device", "cpu"]
    whole = train.run(args)
    shutil.rmtree(d / "step_0000000006")
    resumed = train.run(args)
    assert resumed.start_step == 3
    assert resumed.losses == whole.losses[3:]


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])
