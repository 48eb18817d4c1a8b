"""R007 — a broad ``except`` that can swallow a pending future.

The async pipeline promises every admitted request an explicit answer: a
broad handler that neither re-raises nor resolves a future
(``set_exception``/``set_result``/``_complete_error``) can eat the
failure and leave a caller blocked on ``future.result()`` for ever.
Narrow the types, or justify with ``# repro: allow[R007]``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule, last_name

_RESOLVERS = {"set_exception", "set_result", "_complete_error"}


class R007BroadExcept(Rule):
    id = "R007"
    title = "broad except without re-raise or future resolution"

    def on_except(self, node: ast.ExceptHandler):
        t = node.type
        broad = t is None or (isinstance(t, ast.Name)
                              and t.id in ("Exception", "BaseException"))
        if not broad:
            return
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise) or (
                        isinstance(sub, ast.Call)
                        and last_name(sub) in _RESOLVERS):
                    return
        label = "bare except" if t is None else f"except {t.id}"
        self.report(node, f"{label} neither re-raises nor resolves a "
                          "future (set_exception/set_result/"
                          "_complete_error): it can swallow a pending "
                          "request. Narrow the types or justify with "
                          "# repro: allow[R007].")
