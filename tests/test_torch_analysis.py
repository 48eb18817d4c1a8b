"""Tests for repro_torch.analysis, the port's contract checker (the twin
of tests/test_analysis_lint.py): every rule R001-R009 and L001-L003
fires on its violating snippet, stays quiet on the conforming one and on
the inline-suppressed one (the corpus under tests/lint_corpus/port/);
the live tree (``src/repro_torch`` and ``chip_smoke.py``) is clean and
every allow-list entry is used; the CLI's exit codes, ``--list-rules``,
``--json`` and ``--rules``; and the package imports neither ``jax`` nor
the reference."""
import ast
import json
import pathlib

import pytest

from repro_torch.analysis import (DEFAULT_PATHS, Finding, SourceFile,
                                  check_locks, lint_file, lint_paths)
from repro_torch.analysis import allowlist
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.rules import ALL_RULES

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "lint_corpus" / "port"

RULE_CASES = [
    ("R001", "r001_bad.py", "r001_ok.py", "r001_suppressed.py"),
    ("R002", "r002_bad.py", "r002_ok.py", "r002_suppressed.py"),
    ("R003", "r003_bad.py", "r003_ok.py", "r003_suppressed.py"),
    ("R004", "r004_bad.py", "r004_ok.py", "r004_suppressed.py"),
    ("R005", "repro_torch/core/r005_bad.py", "repro_torch/core/r005_ok.py",
     "repro_torch/core/r005_suppressed.py"),
    ("R006", "solvers/r006_bad.py", "solvers/r006_ok.py",
     "solvers/r006_suppressed.py"),
    ("R007", "r007_bad.py", "r007_ok.py", "r007_suppressed.py"),
    ("R008", "r008_bad.py", "r008_ok.py", "r008_suppressed.py"),
    ("R009", "repro_torch/r009_bad.py", "repro_torch/r009_ok.py",
     "repro_torch/r009_suppressed.py"),
]
LOCK_CASES = [("L001", 2), ("L002", 1), ("L003", 3)]


def _hits(name, rule):
    return [f for f in lint_file(CORPUS / name) if f.rule == rule]


# ---------------------------------------------------------------- rules
@pytest.mark.parametrize("rule,bad,ok,quiet", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_fires_on_violation(rule, bad, ok, quiet):
    assert _hits(bad, rule), f"{rule} did not fire on {bad}"


@pytest.mark.parametrize("rule,bad,ok,quiet", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_quiet_on_conforming(rule, bad, ok, quiet):
    found = lint_file(CORPUS / ok)
    assert found == [], "\n".join(map(str, found))


@pytest.mark.parametrize("rule,bad,ok,quiet", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_quiet_when_suppressed_inline(rule, bad, ok, quiet):
    found = lint_file(CORPUS / quiet)
    assert found == [], "\n".join(map(str, found))
    # the snippet would fire without its suppression comment
    src = (CORPUS / quiet).read_text().replace("repro: allow", "nothing")
    path = CORPUS / quiet
    stripped = [f for cls in ALL_RULES if cls.id == rule
                for f in _run_rule(cls, SourceFile(path, text=src))]
    if rule in ("R004", "R008"):
        assert stripped, rule
    else:
        assert [f.rule for f in stripped] == [rule], stripped


def _run_rule(cls, src):
    from repro_torch.analysis.lint import ProgramRule
    if issubclass(cls, ProgramRule):
        return cls().run_program([src])
    return cls(src).run()


def test_r001_flags_function_and_module_loop():
    msgs = [f.message for f in _hits("r001_bad.py", "R001")]
    assert len(msgs) == 3
    assert any("module-level loop" in m and "torch.compile" in m
               for m in msgs)
    assert sum("'step_graph'" in m for m in msgs) == 2


def test_r002_flags_every_kind_of_region():
    msgs = [f.message for f in _hits("r002_bad.py", "R002")]
    assert len(msgs) == 5
    for what in (".item()", "time.time()", "torch.randn() without "
                 "generator=", "'scan_step', handed to History()",
                 "numpy.random.rand() inside a lambda handed to _capture()"):
        assert any(what in m for m in msgs), (what, msgs)
    assert any("the capture in 'raw_capture'" in m for m in msgs)


def test_r004_reports_lifecycle_mesh_and_redundant_gaps():
    msgs = [f.message for f in _hits("r004_bad.py", "R004")]
    assert len(msgs) == 3
    assert any("'half_baked'" in m and "extract" in m for m in msgs)
    assert any("'mesh_partial'" in m and "mesh_prepare" in m
               and "mesh_placements" in m for m in msgs)
    assert any("'red_partial'" in m and "red_init" in m for m in msgs)


def test_r005_flags_absolute_and_relative_imports():
    msgs = [f.message for f in _hits("repro_torch/core/r005_bad.py",
                                     "R005")]
    assert len(msgs) == 3 and any("'..solvers'" in m for m in msgs)


def test_r006_flags_selector_and_fallbacks():
    msgs = [f.message for f in _hits("solvers/r006_bad.py", "R006")]
    assert len(msgs) == 3
    assert any("is_available" in m for m in msgs)
    assert any("apc_gather_ref()" in m for m in msgs)
    assert any("eager_history()" in m for m in msgs)


def test_r008_reports_both_modes():
    msgs = [f.message for f in _hits("r008_bad.py", "R008")]
    assert any("LsClaim" in m and "ls_reference" in m for m in msgs)
    assert any("SparseClaim" in m and "repro_torch.core.blockops" in m
               for m in msgs)


def test_finding_renders_path_line_rule():
    assert str(Finding("R001", "src/x.py", 3, 5, "boom")) == \
        "src/x.py:3:5: R001 boom"


# ----------------------------------------------------------- lock rules
@pytest.mark.parametrize("rule,count", LOCK_CASES,
                         ids=[c[0] for c in LOCK_CASES])
def test_lock_rule_fires_on_bad_pipeline(rule, count):
    findings = check_locks(SourceFile(CORPUS / "locks_bad.py"))
    assert sum(f.rule == rule for f in findings) == count, findings


def test_lock_checker_names_the_port_blocking_calls():
    msgs = [f.message for f in check_locks(SourceFile(
        CORPUS / "locks_bad.py")) if f.rule == "L003"]
    assert sum(".synchronize()" in m for m in msgs) == 2
    assert any(".run()" in m for m in msgs)


@pytest.mark.parametrize("name", ["locks_ok.py", "locks_suppressed.py"])
def test_lock_checker_quiet(name):
    assert check_locks(SourceFile(CORPUS / name)) == []


def test_lock_suppressions_each_silence_a_finding():
    src = (CORPUS / "locks_suppressed.py").read_text().replace(
        "repro: allow", "nothing")
    found = check_locks(SourceFile(CORPUS / "locks_suppressed.py",
                                   text=src))
    assert sorted(f.rule for f in found) == ["L001", "L002", "L003"]


# ------------------------------------------------------- the live tree
def test_live_tree_is_clean():
    findings = lint_paths()
    assert findings == [], ("portlint findings on the port:\n"
                            + "\n".join(str(f) for f in findings))


def test_default_paths_are_the_port_and_the_chip_check():
    assert DEFAULT_PATHS == ("src/repro_torch", "chip_smoke.py")
    files = {f.relative_to(REPO).as_posix()
             for f in __import__("repro_torch.analysis.lint").analysis
             .lint.iter_py_files()}
    assert "chip_smoke.py" in files
    assert "src/repro_torch/solvers/executor.py" in files
    assert not any("lint_corpus" in f or f.startswith("src/repro/")
                   for f in files)


@pytest.mark.parametrize("rule", sorted(allowlist.ALLOW))
def test_every_allowlist_entry_is_used_and_reasoned(rule, monkeypatch):
    """Dropping any one entry brings back a finding: no entry is stale,
    and each names its reason."""
    full = allowlist.ALLOW[rule]
    for entry in full:
        assert len(entry) == 3 and len(entry[2]) > 20, entry
        monkeypatch.setitem(allowlist.ALLOW, rule,
                            tuple(e for e in full if e is not entry))
        found = [f for f in lint_paths(include_locks=False)
                 if f.rule == rule]
        assert found, f"{rule} allow-list entry {entry[:2]} is unused"
    monkeypatch.setitem(allowlist.ALLOW, rule, full)


# ------------------------------------------------------------------ CLI
def test_cli_clean_on_the_defaults(capsys):
    assert lint_main([]) == 0
    assert capsys.readouterr().out.strip().endswith("portlint: clean")


@pytest.mark.parametrize("bad", [c[1] for c in RULE_CASES]
                         + ["locks_bad.py"])
def test_cli_nonzero_on_every_violation_snippet(bad, capsys):
    assert lint_main([str(CORPUS / bad)]) == 1
    assert "finding" in capsys.readouterr().out


def test_cli_zero_on_conforming_and_suppressed_snippets(capsys):
    paths = [str(CORPUS / c[i]) for c in RULE_CASES for i in (2, 3)]
    assert lint_main(paths + [str(CORPUS / "locks_ok.py"),
                              str(CORPUS / "locks_suppressed.py")]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_rule_selection(capsys):
    # with only R006 selected, an R001 violation passes
    assert lint_main(["--rules", "R006", "--no-locks",
                      str(CORPUS / "r001_bad.py")]) == 0
    assert lint_main(["--rules", "R001", str(CORPUS / "r001_bad.py")]) == 1


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    ids = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert ids == [f"R00{i}" for i in range(1, 10)] + ["L001", "L002",
                                                       "L003"]


def test_cli_json(capsys):
    assert lint_main(["--json", str(CORPUS / "r003_bad.py")]) == 1
    got = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in got] == ["R003"]
    assert set(got[0]) == {"rule", "path", "line", "col", "message"}
    assert lint_main(["--json", str(CORPUS / "r003_ok.py")]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_cli_as_a_module():
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=REPO, capture_output=True, text=True,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(REPO / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "portlint: clean"


# ------------------------------------------------------------- imports
def _imported_heads(path: pathlib.Path) -> set:
    heads = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            heads.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            heads.add((node.module or "").split(".")[0])
    return heads


@pytest.mark.parametrize("path", sorted(
    (REPO / "src" / "repro_torch" / "analysis").rglob("*.py")),
    ids=lambda p: p.relative_to(REPO).as_posix())
def test_analysis_imports_neither_jax_nor_the_reference(path):
    assert not _imported_heads(path) & {"jax", "jaxlib", "repro"}, path


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    heads = _imported_heads(REPO / "chip_smoke.py")
    assert not heads & {"jax", "jaxlib", "repro"}, heads
