"""R005 — layering: ``repro_torch.core`` imports no ``solvers`` or
``kernels`` at module scope.

``core`` holds the numerics and the reference's deprecated shims over
``solvers``; a shim imports lazily, inside its function (``solvers``
imports ``core`` at module scope, so the other direction at module scope
is a cycle that breaks for some import orders).  Only module-scope
imports are flagged.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule

_FORBIDDEN = ("solvers", "kernels")


class R005CoreLayering(Rule):
    id = "R005"
    title = "core/ imports solvers/ or kernels/ at module scope"

    def _in_core(self) -> bool:
        return "core" in self.src.parts

    def _flag(self, node, modname: str):
        self.report(node, f"core/ module imports {modname!r} at module "
                          "scope: a layering violation (an import cycle). "
                          "Import it lazily inside the function.")

    def on_import(self, node: ast.Import):
        if not self._in_core() or self.func_stack:
            return
        for a in node.names:
            parts = a.name.split(".")
            if len(parts) >= 2 and parts[0] == "repro_torch" and (
                    parts[1] in _FORBIDDEN):
                self._flag(node, a.name)

    def on_import_from(self, node: ast.ImportFrom):
        if not self._in_core() or self.func_stack:
            return
        mod = node.module or ""
        parts = mod.split(".") if mod else []
        if node.level >= 2 and (
                (parts and parts[0] in _FORBIDDEN)
                or (not parts and any(a.name in _FORBIDDEN
                                      for a in node.names))):
            self._flag(node, "." * node.level + mod)
        elif len(parts) >= 2 and parts[0] == "repro_torch" and (
                parts[1] in _FORBIDDEN):
            self._flag(node, mod)
        elif parts == ["repro_torch"] and any(a.name in _FORBIDDEN
                                              for a in node.names):
            self._flag(node, mod)
