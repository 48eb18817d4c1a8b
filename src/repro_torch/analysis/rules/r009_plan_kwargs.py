"""R009 — the port's own ``.solve(``/``.solve_many(`` calls pass
``plan=``, not the deprecated loose kwargs.

The execution surface (``backend=``, ``mesh=``, ``use_kernel=``,
``redundancy=``, ``alive_schedule=``, ``store=``, ``precision=``,
``warm_state=``, ``factors=``, ``worker_axes=``, ``model_axis=``) is one
validated ``ExecutionPlan``.  The loose kwargs survive as a shim for
outside callers (one ``DeprecationWarning`` a call); code under
``repro_torch`` does not lean on it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule

_DEPRECATED = frozenset({
    "use_kernel", "precision", "warm_state", "factors", "store",
    "backend", "mesh", "worker_axes", "model_axis", "redundancy",
    "alive_schedule",
})
_METHODS = ("solve", "solve_many")


class R009PlanKwargs(Rule):
    id = "R009"
    title = "internal solve() call passes deprecated loose kwargs"

    def on_call(self, node: ast.Call):
        if "repro_torch" not in self.src.parts:
            return
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _METHODS):
            return
        bad = sorted(kw.arg for kw in node.keywords
                     if kw.arg is not None and kw.arg in _DEPRECATED)
        if bad:
            self.report(
                node, f"{fn.attr}() called with deprecated loose kwargs "
                      f"{bad}: put them on the plan — plan=ExecutionPlan("
                      f"{', '.join(k + '=...' for k in bad)}).")
