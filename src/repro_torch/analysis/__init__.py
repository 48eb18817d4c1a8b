"""repro_torch.analysis — dynamic checkers of the port.

* ``tracecheck`` — attributed zero-rebuild assertions for the captured
  histories and serving executors (the twin of ``repro.analysis
  .tracecheck``).
"""
from __future__ import annotations

from repro_torch.analysis.tracecheck import (TraceError, TraceEvent,
                                             TraceReport, tracecheck)

__all__ = ["TraceError", "TraceEvent", "TraceReport", "tracecheck"]
