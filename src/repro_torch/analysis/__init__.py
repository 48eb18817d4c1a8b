"""repro_torch.analysis — the port's contract lints and dynamic checkers
(the twin of ``repro.analysis``).

* ``lint`` / ``rules`` — "portlint": AST rules R001-R009 over the port's
  contracts (captures built once, nothing host-side in a captured region,
  factor-store ownership, registry completeness, core/ layering, one
  device selector and no silent fallback, future-safe excepts, declared
  modes backed by hooks, internal calls on ``plan=``).
* ``locks`` — the static lock-discipline checker (L001-L003) of the
  threaded serving classes.
* ``tracecheck`` — attributed zero-rebuild assertions for the captured
  histories and serving executors.

CLI: ``python -m repro_torch.analysis [paths...]`` (exit 1 on findings).
"""
from __future__ import annotations

from repro_torch.analysis.lint import (DEFAULT_PATHS, Finding, SourceFile,
                                       lint_file, lint_paths)
from repro_torch.analysis.locks import check_source as check_locks
from repro_torch.analysis.tracecheck import (TraceError, TraceEvent,
                                             TraceReport, tracecheck)

__all__ = [
    "DEFAULT_PATHS", "Finding", "SourceFile", "lint_file", "lint_paths",
    "check_locks", "TraceError", "TraceEvent", "TraceReport", "tracecheck",
]
