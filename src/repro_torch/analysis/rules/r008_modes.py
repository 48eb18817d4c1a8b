"""R008 — a declared system mode is backed by its hooks.

A solver class declaring ``supports`` promises dispatch
(``solvers/capability.py``) that the mode works:

* ``"least_squares"`` needs non-stub ``ls_moment`` and ``ls_reference``
  in its inheritance chain;
* ``"sparse"`` needs a module of the chain to import
  ``repro_torch.core.blockops``, the structure-dispatched contractions
  through which alone a ``SparseBlocks`` operand is consumed.

Inheritance is resolved across every scanned file, as in R004.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (Finding, ProgramRule, SourceFile,
                                       class_table, inherited)

LS_HOOKS = ("ls_moment", "ls_reference")
BLOCKOPS = "repro_torch.core.blockops"


def _declared_supports(cls: ast.ClassDef) -> set[str] | None:
    """The literals of the class body's ``supports = ...``, or None."""
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "supports"
                   for t in targets):
            continue
        if isinstance(value, ast.Call) and value.args:
            value = value.args[0]              # frozenset({...})
        if not isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            return set()                       # dynamic: nothing to check
        return {e.value for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return None


def imports_blockops(src: SourceFile) -> bool:
    """``import repro_torch.core.blockops``, ``from repro_torch.core
    import blockops``, ``from repro_torch.core.blockops import ...`` or
    their relative forms (``from ..core import blockops``)."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            if any(a.name.startswith(BLOCKOPS) for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            absolute = node.level == 0
            if (mod.startswith(BLOCKOPS) if absolute
                    else mod.split(".")[-1] == "blockops"
                    or mod.endswith("core.blockops")):
                return True
            if (mod == "repro_torch.core" if absolute
                    else mod.split(".")[-1] == "core") and any(
                        a.name == "blockops" for a in node.names):
                return True
    return False


class R008ModeHooks(ProgramRule):
    id = "R008"
    title = "declared capability mode without its mode hooks"

    def run_program(self, sources: list[SourceFile]) -> list[Finding]:
        table = class_table(sources)
        findings: list[Finding] = []
        for src in sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                supports = _declared_supports(node)
                if not supports:
                    continue
                defined, _, files = inherited(node, table)
                if "least_squares" in supports:
                    missing = [h for h in LS_HOOKS if h not in defined]
                    if missing:
                        self.report_at(
                            src, node, f"class {node.name!r} declares "
                            f"supports={{'least_squares', ...}} but its "
                            f"chain lacks non-stub {missing}: the LS "
                            "drivers need the optimality moment and the "
                            "lstsq reference.", node.name, findings)
                if "sparse" in supports and not any(
                        imports_blockops(f) for f in files):
                    self.report_at(
                        src, node, f"class {node.name!r} declares "
                        f"supports={{'sparse', ...}} but no module of its "
                        f"chain imports {BLOCKOPS}: a SparseBlocks operand "
                        "goes through its structure-dispatched "
                        "contractions.", node.name, findings)
        return findings
