"""The port's smokes and examples run end to end on the CPU: every smoke of
scripts/smokes_torch/ and every example twin (examples/*_torch.py), each
in a subprocess with ``--device cpu`` and a deadline of its own, and the
port's static checker is clean on all of them (the first step of
scripts/ci_torch.sh).  The smokes assert what their reference twins
assert; here each must exit 0 and print its OK line.

The training example, the port's training and data modules, its
sharding layer and its dry-run launchers (``launch/cells.py``,
``launch/analysis.py``, ``launch/dryrun.py``) import no JAX and nothing
of ``repro`` either (``launch/train.py`` is among the modules portlint
reads).
The scripts are started together, one thread each, when the first test
of the file asks for them (the ``launched`` fixture); each test waits
for its own, and whatever still runs at the end of the module is killed.
"""
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE = 120          # seconds for each script, from the common start
SMOKES = ["registry", "serve", "serve_async", "scenarios", "straggler",
          "elastic", "kernel", "mesh"]
EXAMPLES = {
    "quickstart_torch.py": ([], "elastic: worker 2 died @50"),
    "straggler_sim_torch.py": ([], "straggler mitigation is EXACT"),
    # four ranks (2 workers x 2 column shards) keep the host's cores free
    "distributed_solve_torch.py": (["--ranks", "4"],
                                   "max deviation from single-host"),
    "probe_apc_torch.py": ([], "deviation from closed-form ridge"),
    # ({tmp}: the fixture's directory) a fresh checkpoint directory; four
    # steps reach no checkpoint, so the last step's line is the sign
    "train_lm_torch.py": (["--steps", "4",
                           "--ckpt-dir", "{tmp}/train_lm_ckpt"],
                          "step     3  loss "),
}


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(args):
    p = subprocess.run([sys.executable, *map(str, args)], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=DEADLINE)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return p.stdout


@pytest.fixture(scope="module")
def launched():
    """Every script started at once: name -> (process, stdout file,
    stderr file, start time)."""
    jobs = {f"smoke {s}": [REPO / "scripts" / "smokes_torch" / f"{s}.py",
                           "--device", "cpu"] for s in SMOKES}
    with tempfile.TemporaryDirectory(prefix="scripts_") as tmp:
        jobs.update({f"example {e}": [REPO / "examples" / e, "--device",
                                      "cpu", *(a.format(tmp=tmp)
                                               for a in extra)]
                     for e, (extra, _) in EXAMPLES.items()})
        procs = {}
        for name, args in jobs.items():
            out = open(os.path.join(tmp, name + ".out"), "w+")
            err = open(os.path.join(tmp, name + ".err"), "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, *map(str, args)], cwd=REPO, env=_env(),
                stdout=out, stderr=err, text=True), out, err, time.time())
        try:
            yield procs
        finally:
            for p, out, err, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
                out.close()
                err.close()


def _output(launched, name):
    p, out, err, t0 = launched[name]
    try:
        rc = p.wait(timeout=max(1.0, DEADLINE - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    out.seek(0)
    err.seek(0)
    text = out.read()
    assert rc == 0, text[-2000:] + err.read()[-4000:]
    return text


@pytest.mark.parametrize("smoke", SMOKES)
def test_smoke_twin_runs_on_the_cpu(launched, smoke):
    out = _output(launched, f"smoke {smoke}")
    assert f"{smoke} smoke OK" in out, out


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_example_twin_runs_on_the_cpu(launched, example):
    out = _output(launched, f"example {example}")
    assert EXAMPLES[example][1] in out, out


def test_scripts_import_no_jax_and_lint_clean():
    paths = [*sorted((REPO / "scripts" / "smokes_torch").glob("*.py")),
             *sorted((REPO / "examples").glob("*_torch.py"))]
    assert len(paths) == 10 + len(EXAMPLES), paths
    for p in paths:
        text = p.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro ",
                    "from repro.", "import repro."):
            assert bad not in text, (p, bad)
    for mod in ("launch/train.py", "optim/adamw.py", "optim/schedule.py",
                "optim/compress.py", "data/synthetic.py", "launch/cells.py",
                "launch/analysis.py", "launch/dryrun.py",
                "models/sharding.py"):
        text = (REPO / "src" / "repro_torch" / mod).read_text()
        for bad in ("import jax", "from jax", "from repro.",
                    "import repro."):
            assert bad not in text, (mod, bad)
    assert (REPO / "examples" / "train_lm_torch.py") in paths
    out = _run(["-m", "repro_torch.analysis", "src/repro_torch",
                "chip_smoke.py", *paths])
    assert "portlint: clean" in out
    # the CI entry point names every smoke
    ci = (REPO / "scripts" / "ci_torch.sh").read_text()
    assert all(s in ci for s in SMOKES)
