"""R003 — factor-store bypass.

Every factorization of the serving stack comes through ``FactorStore``
(content-addressed by the system, the solver and its parameters), so it
is paid once a key and the disk tier stays coherent.  A direct
``solver.prepare(...)`` / ``solver.mesh_prepare(...)`` elsewhere repeats
the work and escapes the store's accounting.  The store itself, the
``Solver`` drivers and the placement paths of the mesh, redundant and
elastic backends are the allow-listed owners; a solver calling its own
``self.prepare`` implements the factorization and is no bypass.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule


class R003StoreBypass(Rule):
    id = "R003"
    title = "Solver.prepare/mesh_prepare called outside FactorStore"

    def on_call(self, node: ast.Call):
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("prepare", "mesh_prepare")):
            return
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
            return
        if (isinstance(recv, ast.Call) and isinstance(recv.func, ast.Name)
                and recv.func.id == "super"):
            return
        self.report(node, f"direct .{f.attr}() call bypasses FactorStore: "
                          "acquire factorizations through store.factors(...) "
                          "so they are content-addressed and paid once a "
                          "key.")
