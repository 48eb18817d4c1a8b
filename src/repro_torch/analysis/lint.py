"""portlint — the port's AST contract lints (the twin of
``repro.analysis.lint``).

The port keeps contracts that otherwise live only in docstrings and
ROADMAP prose: a CUDA graph is captured by the executors that own it and
never built per call; a captured region holds no host clock, host RNG or
host sync; factors come through ``FactorStore``; ``repro_torch.core``
imports no ``solvers``/``kernels`` at module scope; one device selector
(``repro_torch.device``) and no silent fallback to a plain version; the
pipeline resolves every future it admits.  This module is the framework
that checks them:

* :class:`SourceFile` — a parsed file, its import aliases and its
  per-line suppressions (``# repro: allow[R001]`` or
  ``# repro: allow[R001,R007]`` on the statement's first line).
* :class:`Rule` — the visitor base: the framework owns the traversal and
  its context (function, class and loop stacks); rules override the
  ``on_*`` hooks and call :meth:`Rule.report`, which applies the inline
  suppressions and the central allow-list (``allowlist.ALLOW``).
* :class:`ProgramRule` — rules that see every file at once (the registry
  resolves a solver's inheritance across modules).
* :func:`lint_paths` — the entry point of the CLI and the tests.

A rule is a module of ``analysis/rules/`` with an ``id`` and a ``title``,
listed in ``rules.ALL_RULES``, with a bad and a conforming snippet under
``tests/lint_corpus/port/``.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import pathlib
import re

# src/repro_torch/analysis/lint.py -> the repo root, three levels up
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

#: what lint_paths scans by default (repo-relative): the port and its
#: chip check.  Tests are left out: the corpus exists to break the rules.
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")

_EXCLUDE_PARTS = {"__pycache__", "lint_corpus", ".git"}

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_\s,]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def dotted(node: ast.AST) -> str | None:
    """``'torch.cuda.graph'`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def last_name(node: ast.Call) -> str:
    """The called name's last component (``run`` of ``ex.run(...)``)."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def is_stub(fn: ast.AST) -> bool:
    """A def whose body (docstring aside) is one ``raise
    NotImplementedError``: an interface stub, not a definition."""
    body = [s for s in fn.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant)
                    and isinstance(s.value.value, str))]
    return len(body) == 1 and isinstance(body[0], ast.Raise) and (
        "NotImplementedError" in ast.dump(body[0]))


class SourceFile:
    """A parsed python file: its AST, import aliases and suppressions."""

    def __init__(self, path: str | pathlib.Path, text: str | None = None,
                 repo_root: pathlib.Path | None = None):
        p = pathlib.Path(path).resolve()
        root = pathlib.Path(repo_root) if repo_root else REPO_ROOT
        try:
            self.relpath = p.relative_to(root).as_posix()
        except ValueError:
            self.relpath = p.as_posix()
        self.text = p.read_text() if text is None else text
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.relpath)
        # line -> the rule ids suppressed on it
        self.suppressed: dict[int, set[str]] = {}
        for i, ln in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(ln)
            if m:
                self.suppressed[i] = {s.strip() for s in m.group(1).split(",")
                                      if s.strip()}
        # local name -> the dotted name it was imported as, so a rule can
        # tell ``np.random.rand`` from ``torch.rand`` however bound
        self.aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for a in node.names:
                    if a.name != "*":
                        self.aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def resolve(self, name: str | None) -> str:
        """``name`` with its leading component expanded by the aliases."""
        if not name:
            return ""
        head, _, rest = name.partition(".")
        full = self.aliases.get(head, head)
        return f"{full}.{rest}" if rest else full

    @property
    def parts(self) -> tuple:
        return pathlib.PurePosixPath(self.relpath).parts


def _allowed(rule: str, relpath: str, qualname: str) -> bool:
    from repro_torch.analysis.allowlist import ALLOW
    return any(path_match(relpath, path_glob)
               and fnmatch.fnmatchcase(qualname, qual_glob)
               for path_glob, qual_glob, _why in ALLOW.get(rule, ()))


def suppressed(rule: str, src: SourceFile, node: ast.AST,
               qualname: str) -> bool:
    """An inline ``# repro: allow[rule]`` on the node's line, or an
    allow-list entry for its file and qualified name."""
    line = getattr(node, "lineno", 1)
    return (rule in src.suppressed.get(line, set())
            or _allowed(rule, src.relpath, qualname))


def finding(rule: str, src: SourceFile, node: ast.AST,
            message: str) -> Finding:
    return Finding(rule, src.relpath, getattr(node, "lineno", 1),
                   getattr(node, "col_offset", 0) + 1, message)


class Rule(ast.NodeVisitor):
    """Visitor base.  Subclasses override the ``on_*`` hooks only; the
    traversal and its context are the framework's, so every rule sees the
    same function, class and loop context."""

    id = "R000"
    title = ""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []
        self.func_stack: list[ast.AST] = []
        self.class_stack: list[ast.ClassDef] = []
        self.loop_depth = 0

    # ---- hooks ------------------------------------------------------
    def on_module(self, node: ast.Module):
        pass

    def on_function(self, node):
        pass

    def on_call(self, node: ast.Call):
        pass

    def on_import(self, node: ast.Import):
        pass

    def on_import_from(self, node: ast.ImportFrom):
        pass

    def on_except(self, node: ast.ExceptHandler):
        pass

    # ---- traversal ----------------------------------------------------
    def run(self) -> list[Finding]:
        self.on_module(self.src.tree)
        self.visit(self.src.tree)
        return self.findings

    def visit_ClassDef(self, node: ast.ClassDef):
        for dec in node.decorator_list:
            self.visit(dec)
        self.class_stack.append(node)
        for child in node.body:
            self.visit(child)
        self.class_stack.pop()

    def _visit_function(self, node):
        # decorators evaluate in the enclosing scope
        for dec in node.decorator_list:
            self.visit(dec)
        self.on_function(node)
        self.func_stack.append(node)
        for child in node.body:
            self.visit(child)
        self.func_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call):
        self.on_call(node)
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import):
        self.on_import(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        self.on_import_from(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        self.on_except(node)
        self.generic_visit(node)

    # ---- reporting ------------------------------------------------------
    def qualname(self) -> str:
        parts = [c.name for c in self.class_stack]
        parts += [getattr(f, "name", "<lambda>") for f in self.func_stack]
        return ".".join(parts)

    def report(self, node: ast.AST, message: str,
               qualname: str | None = None):
        qn = self.qualname() if qualname is None else qualname
        if not suppressed(self.id, self.src, node, qn):
            self.findings.append(finding(self.id, self.src, node, message))


class ProgramRule:
    """A rule over every file at once (a contract that spans modules)."""

    id = "R000"
    title = ""

    def run_program(self, sources: list[SourceFile]) -> list[Finding]:
        raise NotImplementedError

    def report_at(self, src: SourceFile, node: ast.AST, message: str,
                  qualname: str, out: list[Finding]):
        if not suppressed(self.id, src, node, qualname):
            out.append(finding(self.id, src, node, message))


def class_table(sources: list[SourceFile]) -> dict:
    """class name -> (its ClassDef, its file), the first of each name."""
    table: dict[str, tuple[ast.ClassDef, SourceFile]] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                table.setdefault(node.name, (node, src))
    return table


def inherited(cls: ast.ClassDef, table: dict):
    """(the non-stub methods, the class attributes assigned, the files)
    of ``cls`` and its bases, resolved by name through ``table``."""
    methods: set[str] = set()
    attrs: dict[str, ast.AST] = {}
    files: list[SourceFile] = []
    seen: set[str] = set()
    queue = [cls.name]
    while queue:
        name = queue.pop(0)
        if name in seen or name not in table:
            continue
        seen.add(name)
        node, src = table[name]
        files.append(src)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not is_stub(stmt):
                    methods.add(stmt.name)
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        attrs.setdefault(t.id, stmt.value)
        for base in node.bases:
            bname = dotted(base)
            if bname:
                queue.append(bname.split(".")[-1])
    return methods, attrs, files


def path_match(relpath: str, glob: str) -> bool:
    return fnmatch.fnmatchcase(relpath, glob) or relpath.endswith(glob)


def iter_py_files(paths=None, repo_root: pathlib.Path | None = None):
    root = pathlib.Path(repo_root) if repo_root else REPO_ROOT
    for p in (paths or DEFAULT_PATHS):
        pp = pathlib.Path(p)
        if not pp.is_absolute():
            pp = root / pp
        if pp.is_file():
            yield pp
            continue
        for f in sorted(pp.rglob("*.py")):
            if _EXCLUDE_PARTS.isdisjoint(f.parts):
                yield f


def lint_paths(paths=None, rules=None, repo_root=None,
               include_locks: bool = True) -> list[Finding]:
    """Every rule (the AST rules, the program rules and the lock checker)
    over ``paths``: the findings, sorted."""
    from repro_torch.analysis import locks
    from repro_torch.analysis.rules import ALL_RULES

    rule_classes = list(ALL_RULES if rules is None else rules)
    sources = []
    findings: list[Finding] = []
    for f in iter_py_files(paths, repo_root):
        try:
            src = SourceFile(f, repo_root=repo_root)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("PARSE", str(f), getattr(e, "lineno", 1)
                                    or 1, 1, f"unparseable: {e}"))
            continue
        sources.append(src)
        for cls in rule_classes:
            if issubclass(cls, Rule):
                findings.extend(cls(src).run())
        if include_locks:
            findings.extend(locks.check_source(src))
    for cls in rule_classes:
        if issubclass(cls, ProgramRule):
            findings.extend(cls().run_program(sources))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_file(path, rules=None, repo_root=None,
              include_locks: bool = True) -> list[Finding]:
    """Lint one file (the program rules see that file alone)."""
    return lint_paths([path], rules=rules, repo_root=repo_root,
                      include_locks=include_locks)
