"""R006 — the one device selector, and no silent fallback.

``repro_torch.device`` decides where an entry point runs (``cuda``
unless the caller asks for the CPU, raising without a card), and the
kernel ops decide kernel against plain version by where the caller put
the tensors (``ops.on_cuda``).  So:

* a ``torch.cuda.is_available()`` branch outside ``device.py`` is a
  second selector, which runs on the CPU where the caller asked for the
  card;
* an ``except`` handler under ``kernels/`` or ``solvers/`` that calls a
  plain version (a ``*_ref`` op) or the eager loop (``eager_history``,
  ``disable_capture``) is a silent fallback: a kernel that fails to
  build or launch, or a capture that fails, must raise.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule, call_name, last_name

_FALLBACKS = {"eager_history", "disable_capture", "_history_scan",
              "_history_scan_many"}


class R006DeviceAndFallback(Rule):
    id = "R006"
    title = "device selection outside device.py, or a silent fallback"

    def on_call(self, node: ast.Call):
        if self.src.resolve(call_name(node)) != "torch.cuda.is_available":
            return
        if self.src.relpath.endswith("repro_torch/device.py"):
            return
        self.report(node, "torch.cuda.is_available() outside "
                          "repro_torch/device.py: a second device selector. "
                          "Take the caller's device (device.resolve) or the "
                          "tensors' (ops.on_cuda).")

    def on_except(self, node: ast.ExceptHandler):
        if not ({"kernels", "solvers"} & set(self.src.parts)):
            return
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                name = last_name(sub)
                if name.endswith("_ref") or name in _FALLBACKS:
                    self.report(sub, f"{name}() in an except handler: a "
                                     "silent fallback to a plain version "
                                     "or the eager loop. A failed build, "
                                     "launch or capture must raise.")
