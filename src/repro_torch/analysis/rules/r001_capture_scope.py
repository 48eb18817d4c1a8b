"""R001 — a CUDA graph capture (or a compile) built inside a function or
loop body.

The port's compile-once unit is the captured CUDA graph.  A graph, a
``torch.compile`` or a ``torch.jit`` program built per call pays its
capture or compile on every call, and a steady state that is supposed to
replay builds instead, silently.  Captures belong to the owners of
``solvers.executor``: ``_capture`` (the one place a ``CUDAGraph`` is
made), the programs it captures (``_Program``, ``_Loop``,
``StepProgram``) and the executors and engines that build them once
(``LocalExecutor``, ``RedundantEngine``, the mesh's runners); those are
the allow-listed sites (``allowlist.ALLOW``).  A construction at module
scope, outside any loop, is built once and is fine.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule, call_name

_CAPTURE = {"torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
            "torch.cuda.graph", "torch.cuda.graphs.graph",
            "torch.cuda.make_graphed_callables", "torch.compile",
            "torch.jit.script", "torch.jit.trace"}
# the executor's own capture helpers, however imported
_PORT = {"_capture", "_Program", "_Loop", "StepProgram"}


class R001CaptureInFunction(Rule):
    id = "R001"
    title = "CUDA graph capture or compile built inside a function/loop body"

    def _builds(self, node: ast.Call) -> str | None:
        name = self.src.resolve(call_name(node))
        if name in _CAPTURE:
            return name
        tail = name.rsplit(".", 1)[-1]
        return tail if tail in _PORT else None

    def on_call(self, node: ast.Call):
        built = self._builds(node)
        if built is None:
            return
        if self.func_stack:
            where = f"function {self.qualname()!r}"
        elif self.loop_depth:
            where = "a module-level loop"
        else:
            return
        self.report(node, f"{built}() built inside {where}: a capture or "
                          "compile made per call is paid on every call "
                          "(no steady-state replay). Build it once, in the "
                          "executor that owns it (solvers.executor), and "
                          "replay.")
