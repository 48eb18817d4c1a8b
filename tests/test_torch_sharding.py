"""The port's sharding layer (``repro_torch.models.sharding`` on a
``DeviceMesh``) against the JAX reference and against its own one-device
runs, on the CPU.

* **Rules.**  ``rules_for_mesh`` on the (1, 1) host mesh and on the fake
  (16, 16) and (2, 16, 16) production meshes equals the reference's
  field for field (the reference reads only a mesh's ``axis_names``, so
  it is handed a stand-in with the same names); ``to_pspec`` holds the
  cases of tests/test_sharding_rules.py; ``pspec_tree`` of
  ``model_abstract`` and ``cache_abstract(cfg, 2, 8)`` equals the
  reference's ``P``s read as tuples for all ten architectures; every
  ``tensor``-sharded dim divides 16; ``abstract_state`` and
  ``state_pspecs`` equal the reference's.  The fake meshes run in a
  subprocess: torch's fake process group becomes that process's default
  group.
* **Sharded ≡ one device.**  Gloo ranks on the CPU, spawned as in
  tests/test_torch_mesh_ranks.py, on (1, 2), (2, 1) and (2, 2) meshes:
  the smoke configs of the dense, moe, ssm, hybrid, mla and audio
  families (capacity factor 32: no token drops, so the expert-parallel
  path computes the global one's function), their forward, loss,
  gradients and prefill + two decode steps against the port's one-device
  run on the same parameters, within 2e-5 of max + 1 in float32.  The
  one-device run is held to the reference by tests/test_torch_models.py
  and tests/test_torch_train.py.
* **Expert-parallel MoE.**  The port's sharded ``moe_apply`` on a (2, 4)
  mesh of 8 gloo ranks against the reference's ``_moe_shard_map`` on 8
  host devices (one JAX subprocess), at capacity factor 1.25 and at 0.25,
  where per-shard capacity drops tokens so that sharded differs from
  global; port and reference agree within 2e-5 of max + 1 at both.
* **The train CLI.**  ``--data 2`` and ``--model-axis 2`` on two gloo
  ranks, 6 steps, the losses against the one-device run's within 2e-5
  relative; a checkpoint written sharded resumes on one device, and one
  written on one device resumes sharded.  With ``--compress-grads`` on
  (1, 2) and (2, 1): the int8 roundtrip of DTensor leaves ≡ the
  one-device function on the global leaves, bit for bit; the losses of 6
  steps and the parameters of the last checkpoint against the one-device
  run's within 2e-5 of max + 1 (but for the few rounding-boundary
  elements the test names).
"""
import os
import shutil
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240.0
F32 = 2e-5                      # x (max|one device| + 1), float32
ARCHS = ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "mamba2-130m",
         "jamba-v0.1-52b", "deepseek-v2-236b", "whisper-tiny")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
COMPRESS_MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
B, S, NEW = 2, 8, 2             # batch, prompt, decode steps
MOE_X = (4, 16, 64)             # the expert-parallel case's input
MOE_CF = (1.25, 0.25)
TRAIN = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "6", "--batch",
         "4", "--seq", "16", "--ckpt-every", "3", "--log-every", "100",
         "--device", "cpu"]
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _ref_rules(names):
    from repro.models import sharding as ref_sharding
    return ref_sharding.rules_for_mesh(types.SimpleNamespace(
        axis_names=tuple(names)))


def _fields(r):
    return (r.batch, r.fsdp, r.tensor, r.seq_sp, r.kv_seq)


def test_rules_for_the_host_mesh_match_the_reference():
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding
    if not dist.is_initialized():
        mesh_lib.init_group("cpu")
    m = mesh_lib.make_host_mesh(device="cpu")
    r = sharding.rules_for_mesh(m)
    assert r.mesh is m
    assert r.batch and r.resolve(None) is None
    assert _fields(r) == _fields(_ref_rules(m.mesh_dim_names))


def test_to_pspec_resolution():
    from repro_torch.models import sharding
    r = sharding.Rules(batch=("pod", "data"), fsdp="data", tensor="model",
                       seq_sp="model", kv_seq="model")
    assert sharding.to_pspec(("batch", None, "tensor"), r) == (
        ("pod", "data"), None, "model")
    r2 = sharding.Rules(batch=(), fsdp=None, tensor=None, seq_sp=None,
                        kv_seq=None)
    assert sharding.to_pspec(("batch", "fsdp"), r2) == (None, None)
    assert sharding.to_pspec(("batch",), sharding.Rules()) == ("data",)


def test_placements_split_pod_major_and_refuse_a_dim_named_twice():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import sharding
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # a tree of ParamSpecs to each leaf's placements
    ab = {"w": sharding.ParamSpec((4, 8), ("fsdp", "tensor")),
          "b": [sharding.ParamSpec((8,), (None,))]}
    r = sharding.Rules(batch=("pod", "data"))
    assert sharding.sharding_tree(ab, r, mesh) == {
        "w": (Replicate(), Shard(0), Shard(1)),
        "b": [(Replicate(), Replicate(), Replicate())]}
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(("model", "model"), mesh)
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), mesh)


def _as_tuple(p):
    return tuple(p)


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b", "deepseek-7b", "deepseek-coder-33b", "qwen3-4b",
    "deepseek-v2-236b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "pixtral-12b",
    "mamba2-130m", "whisper-tiny"])
@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_spec_trees_match_the_reference(arch, names):
    import jax
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    from repro.models import sharding as ref_sharding
    from repro.optim import adamw as ref_adamw
    from repro_torch import configs
    from repro_torch.models import model, sharding
    from repro_torch.optim import adamw
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    rr = _ref_rules(names)
    r = sharding.Rules(*_fields(rr))
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for ab, ref_ab in ((model.model_abstract(cfg),
                        ref_model.model_abstract(ref_cfg)),
                       (model.cache_abstract(cfg, 2, 8),
                        ref_model.cache_abstract(ref_cfg, 2, 8))):
        got = sharding.tree_leaves(sharding.pspec_tree(ab, r),
                                   sharding.is_pspec)
        want = [_as_tuple(p) for p in jax.tree.leaves(
            ref_sharding.pspec_tree(ref_ab, rr), is_leaf=is_p)]
        assert got == want
    # the optimizer state's specs and its abstract leaves
    specs = sharding.pspec_tree(model.model_abstract(cfg), r)
    st = adamw.state_pspecs(specs)
    ref_st = ref_adamw.state_pspecs(ref_sharding.pspec_tree(
        ref_model.model_abstract(ref_cfg), rr))
    assert st.step == _as_tuple(ref_st.step)
    for mine, ref in ((st.m, ref_st.m), (st.v, ref_st.v)):
        assert sharding.tree_leaves(mine, sharding.is_pspec) == [
            _as_tuple(p) for p in jax.tree.leaves(ref, is_leaf=is_p)]
    sds = sharding.sds_tree(model.model_abstract(cfg),
                            model.cache_dtype(cfg))
    ab_state = adamw.abstract_state(sds)
    ref_state = ref_adamw.abstract_state(ref_sharding.sds_tree(
        ref_model.model_abstract(ref_cfg), jax.numpy.dtype(ref_cfg.dtype)))
    assert ab_state.step.device.type == "meta"
    assert (tuple(ab_state.step.shape), str(ab_state.step.dtype)) == (
        tuple(ref_state.step.shape), "torch." + str(ref_state.step.dtype))
    for mine, ref in ((ab_state.m, ref_state.m), (ab_state.v, ref_state.v)):
        got = [(tuple(t.shape), t.dtype, t.device.type)
               for t in sharding.tree_leaves(mine)]
        assert got == [(tuple(s.shape), torch.float32, "meta")
                       for s in jax.tree.leaves(ref)]


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b", "deepseek-7b", "deepseek-coder-33b", "qwen3-4b",
    "deepseek-v2-236b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "pixtral-12b",
    "mamba2-130m", "whisper-tiny"])
def test_tensor_sharded_dims_divide_the_model_axis(arch):
    """The divisibility contract the dry-run relies on
    (tests/test_sharding_rules.py::test_tensor_sharded_dims_divide_mesh)."""
    from repro_torch import configs
    from repro_torch.models import model, sharding
    for s in sharding.tree_leaves(model.model_abstract(configs.get(arch))):
        assert len(s.shape) == len(s.logical), (arch, s)
        for dim, name in zip(s.shape, s.logical):
            if name == "tensor":
                assert dim % 16 == 0, (arch, s)


FAKE_RULES = """
import json, sys, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding
out = {}
for multi in (False, True):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    r = sharding.rules_for_mesh(mesh)
    out[str(multi)] = [list(mesh.mesh_dim_names), list(mesh.mesh.shape),
                       [r.batch, r.fsdp, r.tensor, r.seq_sp, r.kv_seq],
                       r.mesh is mesh]
print(json.dumps(out))
"""


def test_rules_for_the_production_meshes_match_the_reference():
    """The fake 256- and 512-rank groups of ``make_production_mesh``, in a
    subprocess (the group becomes its default one)."""
    r = subprocess.run([sys.executable, "-c", FAKE_RULES], env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for multi, shape, names in ((False, [16, 16], ["data", "model"]),
                                (True, [2, 16, 16],
                                 ["pod", "data", "model"])):
        g = got[str(multi)]
        assert g[0] == names and g[1] == shape and g[3] is True
        want = [list(x) if isinstance(x, tuple) else x
                for x in _fields(_ref_rules(names))]
        assert g[2] == want


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _child(rank, world, out, case, params):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        got = CASES[case](rank, out, params)
    finally:
        dist.destroy_process_group()
    if got is not None:
        np.savez(os.path.join(out, f"rank{rank}.npz"), **got)


def _cfg(arch):
    """The smoke config, at a capacity factor where no token drops."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0))
    return cfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + NEW)))
    batch = {"tokens": tok[:, :S], "labels": tok[:, 1:S + 1]}
    if cfg.frontend == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return tok, batch


def _params(cfg):
    from repro_torch.models import model, sharding
    params = sharding.init_tree(model.model_abstract(cfg),
                                torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    for t in sharding.tree_leaves(params):
        t.requires_grad_()
    return params


def _results(cfg, params, batch, tok, rules=None, place=lambda t, ax: t):
    """forward logits, loss, gradients, prefill + decode logits, as
    float64 numpy arrays (the full tensors)."""
    from repro_torch.launch import train
    from repro_torch.models import model, sharding
    full = lambda t: np.asarray(  # noqa: E731
        (t.full_tensor() if sharding.is_dtensor(t) else t).detach(),
        np.float64)
    got = {}
    fwd = {k: place(v, ("batch",) + (None,) * (v.dim() - 1))
           for k, v in batch.items() if k != "labels"}
    got["fwd"] = full(model.forward(cfg, params, fwd, rules=rules))
    lb = {k: place(v, ("batch",) + (None,) * (v.dim() - 1))
          for k, v in batch.items()}
    loss, grads = train.loss_and_grads(cfg, params, lb, rules)
    got["loss"] = full(loss)
    for i, g in enumerate(sharding.tree_leaves(grads)):
        got[f"grad{i}"] = full(g)
    ab = model.cache_abstract(cfg, B, S + NEW)
    cache = sharding.tree_map(
        lambda s: place(torch.zeros(s.shape), s.logical), ab)
    with torch.no_grad():
        lg, cache = model.prefill(cfg, params, fwd, cache, rules=rules)
        steps = [full(lg)]
        for i in range(NEW):
            lg, cache = model.decode_step(
                cfg, params, place(tok[:, S + i:S + i + 1], ("batch", None)),
                cache, S + i, rules=rules)
            steps.append(full(lg))
    got["serve"] = np.stack(steps)
    return got


def _case_equal(rank, out, params):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model, sharding
    mesh = mesh_lib.make_mesh(params["shape"], ("data", "model"), "cpu")
    rules = sharding.rules_for_mesh(mesh)

    def place(t, logical):
        pl = sharding.placements(sharding.to_pspec(logical, rules), mesh)
        return sharding.local_part(t, mesh, pl)

    got = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tok, batch = _inputs(cfg)
        dp = sharding.shard_tree(_params(cfg), model.model_abstract(cfg),
                                 rules, mesh)
        res = _results(cfg, dp, batch, tok, rules, place)
        got.update({f"{arch}/{k}": v for k, v in res.items()})
    return got if rank == 0 else None


def _case_moe(rank, out, params):
    import dataclasses
    from repro_torch import configs, interop
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe, sharding
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
    rules = sharding.rules_for_mesh(mesh)
    ref = np.load(params["ref"], allow_pickle=True)
    base = configs.get_smoke("qwen3-moe-30b-a3b")
    ab = moe.moe_abstract(base)
    p = interop.params_from_numpy(ref["params"].item(), device="cpu")
    dp = sharding.shard_tree(p, ab, rules, mesh)
    x = torch.as_tensor(ref["x"])
    xd = sharding.local_part(x, mesh, sharding.placements(
        sharding.to_pspec(("batch", None, None), rules), mesh))
    got = {}
    for cf in MOE_CF:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        with sharding.on_mesh(rules):
            y = moe.moe_apply(cfg, dp, xd, rules=rules)
        got[f"{cf}"] = y.full_tensor().numpy()
        got[f"{cf}/global"] = moe.moe_apply(cfg, p, x).numpy()
    return got if rank == 0 else None


def _case_train(rank, out, params):
    import contextlib
    import io
    from repro_torch.launch import train
    got = {}
    for flag in ("--data", "--model-axis"):
        with contextlib.redirect_stdout(io.StringIO()):
            rep = train.run(TRAIN + [flag, "2", "--ckpt-dir",
                                     os.path.join(out, f"ck{flag}")])
        got[flag] = np.asarray(rep.losses)
    # the one-device run's checkpoint (step 3), resumed sharded
    with contextlib.redirect_stdout(io.StringIO()):
        rep = train.run(TRAIN + ["--model-axis", "2", "--ckpt-dir",
                                 params["one"]])
    got["resumed"] = np.asarray(rep.losses)
    got["start"] = np.asarray(rep.start_step)
    return got if rank == 0 else None


def _compress_inputs():
    """Seeded float32 (gradient, error buffer) leaves of the train CLI's
    parameter shapes, the buffers a quantization step's size."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import sharding
    cfg = configs.get_smoke(TRAIN[1])
    like = train.init_params(cfg, torch.device("cpu"))
    rng = np.random.default_rng(0)
    shapes = [t.shape for t in sharding.tree_leaves(like)]
    grads = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in shapes]
    errs = [torch.as_tensor(rng.standard_normal(s) / 256.0,
                            dtype=torch.float32) for s in shapes]
    return cfg, like, grads, errs


def _case_compress(rank, out, params):
    import contextlib
    import io
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model, sharding
    from repro_torch.optim import compress
    got = {}
    cfg, like, grads, errs = _compress_inputs()
    ab = model.model_abstract(cfg)
    for name, (d, m) in COMPRESS_MESHES.items():
        mesh = mesh_lib.make_host_mesh(d, m, torch.device("cpu"))
        rules = sharding.rules_for_mesh(mesh)
        tree = lambda leaves: sharding.shard_tree(    # noqa: E731
            sharding.tree_unflatten(like, leaves), ab, rules, mesh)
        g, e = tree(grads), tree(errs)
        zeros = compress.init_error(g)
        placed = all(z.placements == p.placements for z, p in zip(
            sharding.tree_leaves(zeros), sharding.tree_leaves(g)))
        got[f"{name}/placed"] = np.asarray(placed)
        for step in range(2):           # the buffers carried a step
            g, e = compress.compress_decompress(g, e)
            placed = all(a.placements == b.placements for a, b in zip(
                sharding.tree_leaves(g), sharding.tree_leaves(e)))
            got[f"{name}/placed"] &= placed
            for i, (a, b) in enumerate(zip(sharding.tree_leaves(g),
                                           sharding.tree_leaves(e))):
                got[f"{name}/{step}/deq{i}"] = a.full_tensor().numpy()
                got[f"{name}/{step}/err{i}"] = b.full_tensor().numpy()
    for name, (d, m) in COMPRESS_MESHES.items():
        ck = os.path.join(out, f"ck{name}")
        with contextlib.redirect_stdout(io.StringIO()):
            rep = train.run(TRAIN + ["--data", str(d), "--model-axis",
                                     str(m), "--compress-grads",
                                     "--ckpt-dir", ck])
        got[f"{name}/losses"] = np.asarray(rep.losses)
        if rank == 0:
            for i, leaf in enumerate(_ckpt_params(ck)):
                got[f"{name}/param{i}"] = leaf
    return got if rank == 0 else None


def _ckpt_params(directory):
    """The parameters of the train CLI's last checkpoint in
    ``directory``, as float32 arrays in tree order."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.models import sharding
    from repro_torch.optim import adamw
    cfg = configs.get_smoke(TRAIN[1])
    params = train.init_params(cfg, torch.device("cpu"))
    params, _ = ckpt.restore(directory, (params, adamw.init(params)))
    return [t.detach().float().numpy() for t in sharding.tree_leaves(params)]


CASES = {"equal": _case_equal, "moe": _case_moe, "train": _case_train,
         "compress": _case_compress}


def _start(case, world, out, params=None):
    import torch.multiprocessing as mp
    os.makedirs(out, exist_ok=True)
    return mp.start_processes(_child, args=(world, out, case, params or {}),
                              nprocs=world, join=False,
                              start_method="spawn")


def _wait(ctx, out, label):
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{label} did not finish within "
                                   f"{DEADLINE:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return dict(np.load(os.path.join(out, "rank0.npz"), allow_pickle=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results by mesh, the one-device results by arch): every
    mesh's ranks started together, the one-device runs made meanwhile."""
    root = tmp_path_factory.mktemp("sharded")
    ctxs = {name: _start("equal", shape[0] * shape[1], str(root / name),
                         {"shape": shape})
            for name, shape in MESHES.items()}
    one = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        tok, batch = _inputs(cfg)
        one[arch] = _results(cfg, _params(cfg), batch, tok)
    return ({name: _wait(ctx, str(root / name), name)
             for name, ctx in ctxs.items()}, one)


def _close(got, want, tol=F32):
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1.0)
    assert err < tol, err
    return err


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["fwd", "loss", "grads", "serve"])
def test_sharded_equals_one_device(runs, mesh, arch, what):
    got, want = runs[0][mesh], runs[1][arch]
    keys = ([k for k in want if k.startswith("grad")] if what == "grads"
            else [what])
    assert keys
    for k in keys:
        assert got[f"{arch}/{k}"].shape == want[k].shape, k
        _close(got[f"{arch}/{k}"], want[k])


# ---------------------------------------------------------------------------
# the expert-parallel MoE against the reference's shard_map path
# ---------------------------------------------------------------------------


REF_MOE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_compat_mesh
from repro.models import moe, sharding
base = configs.get_smoke("qwen3-moe-30b-a3b")
p = sharding.init_tree(moe.moe_abstract(base), jax.random.PRNGKey(0),
                       jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), {shape}, jnp.float32)
mesh = make_compat_mesh((2, 4), ("data", "model"))
rules = sharding.rules_for_mesh(mesh)
out = dict(x=np.asarray(x), params=jax.tree.map(np.asarray, p))
for cf in {cfs}:
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    with mesh:
        y = jax.jit(lambda p, x: moe.moe_apply(cfg, p, x, rules))(p, x)
    out[str(cf)] = np.asarray(y)
    out[str(cf) + "/global"] = np.asarray(moe.moe_apply(cfg, p, x))
np.save(sys.argv[1], out, allow_pickle=True)
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    ref = str(root / "ref.npy")
    code = REF_MOE.format(shape=MOE_X, cfs=MOE_CF)
    r = subprocess.run([sys.executable, "-c", code, ref], capture_output=True,
                       text=True, timeout=300, env=dict(
                           ENV, XLA_FLAGS="--xla_force_host_platform_"
                                          "device_count=8"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(ref, allow_pickle=True).item()
    npz = str(root / "ref.npz")
    np.savez(npz, x=want["x"], params=np.asarray(want["params"],
                                                 dtype=object))
    got = _wait(_start("moe", 8, str(root / "ranks"), {"ref": npz}),
                str(root / "ranks"), "moe")
    return got, want


@pytest.mark.parametrize("cf", MOE_CF)
def test_expert_parallel_moe_matches_the_references_shard_map(moe_runs, cf):
    got, want = moe_runs
    _close(got[f"{cf}"], want[f"{cf}"])
    # the one-device (global) path agrees with the reference's global path
    _close(got[f"{cf}/global"], want[f"{cf}/global"])
    dropped = np.max(np.abs(want[f"{cf}"] - want[f"{cf}/global"]))
    if cf == MOE_CF[1]:     # per-shard capacity drops other entries
        assert dropped > 1e-3, dropped
    else:
        assert dropped < 1e-5, dropped


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_a_mesh_matches_one_device(tmp_path):
    import contextlib
    import io
    from repro_torch.launch import train
    one = str(tmp_path / "one")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = train.run(TRAIN + ["--ckpt-dir", one])
    want = np.asarray(ref.losses)
    resume = str(tmp_path / "one_at_3")
    shutil.copytree(one, resume)
    shutil.rmtree(os.path.join(resume, "step_0000000006"))
    out = str(tmp_path / "ranks")
    got = _wait(_start("train", 2, out, {"one": resume}), out, "train")
    for flag in ("--data", "--model-axis"):
        np.testing.assert_allclose(got[flag], want, rtol=F32, atol=0)
    assert int(got["start"]) == 3
    np.testing.assert_allclose(got["resumed"], want[3:], rtol=F32, atol=0)
    # a checkpoint the sharded run wrote (step 3) resumes on one device
    sharded = str(tmp_path / "sharded_at_3")
    shutil.copytree(os.path.join(out, "ck--model-axis"), sharded)
    shutil.rmtree(os.path.join(sharded, "step_0000000006"))
    with contextlib.redirect_stdout(io.StringIO()):
        rep = train.run(TRAIN + ["--ckpt-dir", sharded])
    assert rep.start_step == 3
    np.testing.assert_allclose(rep.losses, want[3:], rtol=F32, atol=0)


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """(rank 0's results by mesh, the one-device run's losses and
    parameters), every run with ``--compress-grads``; the one-device run
    made while the ranks run."""
    import contextlib
    import io
    from repro_torch.launch import train
    root = tmp_path_factory.mktemp("compress")
    out = str(root / "ranks")
    ctx = _start("compress", 2, out)
    one = str(root / "one")
    with contextlib.redirect_stdout(io.StringIO()):
        rep = train.run(TRAIN + ["--compress-grads", "--ckpt-dir", one])
    return _wait(ctx, out, "compress"), (np.asarray(rep.losses),
                                         _ckpt_params(one))


@pytest.mark.parametrize("mesh", list(COMPRESS_MESHES))
def test_compress_decompress_on_a_mesh_is_the_global_leaves_bit_for_bit(
        compressed, mesh):
    """DTensor gradients and error buffers in the parameters' placements,
    two steps: the dequantized gradients and the new buffers equal, bit
    for bit, what the one-device function makes of the global leaves,
    and stay in those placements (``init_error``'s buffers too)."""
    from repro_torch.optim import compress
    got = compressed[0]
    assert bool(got[f"{mesh}/placed"])
    _, _, g, e = _compress_inputs()
    for step in range(2):
        g, e = compress.compress_decompress(g, e)
        for i, (a, b) in enumerate(zip(g, e)):
            np.testing.assert_array_equal(got[f"{mesh}/{step}/deq{i}"],
                                          a.numpy())
            np.testing.assert_array_equal(got[f"{mesh}/{step}/err{i}"],
                                          b.numpy())


@pytest.mark.parametrize("mesh", list(COMPRESS_MESHES))
def test_train_cli_compresses_gradients_on_a_mesh_as_on_one_device(
        compressed, mesh):
    """``--compress-grads`` on a mesh trains as the one-device run does:
    the losses of 6 steps within 2e-5 of max + 1, and the parameters
    after them within 2e-5 of max + 1 but at the few elements where the
    mesh's gradient, summed in another order (uncompressed, the two
    runs' parameters agree within 7e-7), fell on the other side of an
    int8 rounding boundary: one level of that block's scale, carried by
    the error buffer, which AdamW's normalized step turns into at most
    about the learning rate a step.  Those are under 1e-3 of the
    elements, each within 6 x 1e-3 (6 steps at lr 1e-3)."""
    got, (losses, params) = compressed
    assert got[f"{mesh}/losses"].shape == losses.shape == (6,)
    _close(got[f"{mesh}/losses"], losses)
    assert len(params) > 1
    flipped = total = 0
    for i, want in enumerate(params):
        have = got[f"{mesh}/param{i}"]
        assert have.shape == want.shape, i
        off = np.abs(have - want) / (np.max(np.abs(want)) + 1.0) >= F32
        assert np.max(np.abs(have - want)) <= 6 * 1e-3, i
        _close(np.where(off, want, have), want)
        flipped += int(off.sum())
        total += want.size
    assert flipped < 1e-3 * total, (flipped, total)
