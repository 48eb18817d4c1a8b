"""tracecheck — attributed detection of executor builds and CUDA graph
captures (the twin of ``repro.analysis.tracecheck``).

The reference's serving contract is zero steady-state retraces: after
warmup no call may trace a jitted function.  The port's compile-once
unit is the captured CUDA graph (``solvers.executor``), so its events are
the executor's program builds and its graph captures.  The executor
reports each one, synchronously, from the stack of the call that caused
it (:func:`record`); the innermost frame outside the port's package,
``torch`` and ``contextlib`` is the line of user code that caused it.

Usage::

    with tracecheck() as tc:              # record + attribute
        ...
    print(tc.summary())

    with tracecheck(steady_state=True):   # assert zero builds/captures
        ex.run(A, factors, Bb)            # raises TraceError naming the
                                          # call site if anything built

``steady_state=True`` raises :class:`TraceError` naming every event and
its ``file:line`` call site.  Event names are ``"build <solver>.cold"``
/ ``".warm"`` and ``"capture <program>"``; ``allow`` takes fnmatch
patterns on them.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import fnmatch
import os
import threading
import traceback

import torch

# frames in the port's package, in torch and in these modules are
# machinery, not the call site
_INTERNAL_DIRS = tuple(os.path.dirname(os.path.abspath(f)) + os.sep for f in (
    os.path.dirname(__file__),                    # src/repro_torch/analysis
    torch.__file__, concurrent.futures.__file__))
_INTERNAL_FILES = (contextlib.__file__, threading.__file__)

_active: list = []
_lock = threading.Lock()


@dataclasses.dataclass
class TraceEvent:
    """One build or capture, attributed to the user-code line that caused
    it."""

    fun: str
    path: str
    line: int
    code: str
    thread: str
    signature: str | None = None

    @property
    def where(self) -> str:
        return f"{self.path}:{self.line}"

    def __str__(self) -> str:
        sig = f" {self.signature}" if self.signature else ""
        return (f"{self.fun!r}{sig} at {self.where} ({self.code}) "
                f"[thread {self.thread}]")


class TraceError(AssertionError):
    """A steady-state region built or captured; the message names the
    call site."""


class TraceReport:
    """Accumulates :class:`TraceEvent`s for one tracecheck window."""

    def __init__(self, allow: tuple[str, ...] = ()):
        self.allow = tuple(allow)
        self.events: list[TraceEvent] = []
        self._lock = threading.Lock()

    def _add(self, ev: TraceEvent):
        with self._lock:
            self.events.append(ev)

    def traces(self, fun: str | None = None) -> list[TraceEvent]:
        with self._lock:
            evs = list(self.events)
        if fun is None:
            return evs
        return [e for e in evs if fnmatch.fnmatchcase(e.fun, fun)]

    def unexpected(self) -> list[TraceEvent]:
        return [e for e in self.traces()
                if not any(fnmatch.fnmatchcase(e.fun, pat)
                           for pat in self.allow)]

    def summary(self) -> str:
        evs = self.traces()
        if not evs:
            return "tracecheck: 0 trace events"
        lines = [f"tracecheck: {len(evs)} trace event(s):"]
        lines += [f"  - {e}" for e in evs]
        return "\n".join(lines)

    def assert_zero(self, context: str = "steady state"):
        bad = self.unexpected()
        if bad:
            lines = [f"{len(bad)} build(s)/capture(s) in a zero-retrace "
                     f"region ({context}):"]
            lines += [f"  - {e}" for e in bad]
            raise TraceError("\n".join(lines))


def _internal(path: str) -> bool:
    path = os.path.abspath(path)
    return path.startswith(_INTERNAL_DIRS) or path in _INTERNAL_FILES


def record(fun: str, signature: str | None = None) -> None:
    """Report one build or capture to every open :func:`tracecheck`
    window, attributed to the innermost frame of user code on the
    calling thread's stack."""
    with _lock:
        reports = list(_active)
    if not reports:
        return
    site = None
    for frame in traceback.extract_stack():
        if not _internal(frame.filename):
            site = frame                 # keep the DEEPEST non-internal one
    path, line, code = (("<unknown>", 0, "") if site is None else
                        (site.filename, site.lineno, site.line or ""))
    ev = TraceEvent(fun=fun, path=path, line=line, code=code.strip(),
                    thread=threading.current_thread().name,
                    signature=signature)
    for report in reports:
        report._add(ev)


@contextlib.contextmanager
def tracecheck(steady_state: bool = False, allow: tuple[str, ...] = ()):
    """Record every executor build and graph capture in the body,
    attributed to its call site.

    ``steady_state=True`` raises :class:`TraceError` on exit if any
    happened (minus ``allow`` fnmatch patterns on the event name) — the
    message names each offending call site.
    """
    report = TraceReport(allow=allow)
    with _lock:
        _active.append(report)
    try:
        yield report
    finally:
        with _lock:
            _active.remove(report)
    if steady_state:
        report.assert_zero()
