"""Static lock-discipline checker for ``pipeline.py``-style classes (the
twin of ``repro.analysis.locks``).

The async server's contract is a single assembly thread plus a device
pool, with every shared mutation under ``self._lock`` and every
blocking call OUTSIDE it.  This checker re-derives that contract from
the source, per class that starts threads:

* **thread contexts** — ``threading.Thread(target=self._m)`` and
  ``self._pool.submit(self._m, ...)`` mark ``_m`` as a worker entry;
  methods reachable from an entry through ``self.x()`` calls inherit
  its context; public / externally-called methods run on the caller
  ("main") thread.
* **shared fields** — a ``self.f`` attribute written from >= 2 distinct
  contexts (assignment, augmented assignment, subscript store, or a
  mutator call such as ``.append``/``.add``/``.discard``).
* **L001** shared field mutated outside ``with self._lock:`` (a method
  whose every intra-class call site holds the lock counts as held —
  that is how ``_next_group`` is proven safe).
* **L002** ``Condition.wait`` without the lock held.
* **L003** blocking call (an event's or the device's ``.synchronize``,
  ``.join``, ``.shutdown``, ``.result``, ``.acquire``, an executor's
  ``.run``) inside a ``with self._lock:`` body — holding the lock across
  a wait on the card or another thread serializes the pipeline it exists
  to overlap.

Findings respect ``# repro: allow[L00x]`` suppressions and the central
allow-list, like every other rule.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (Finding, SourceFile, dotted, finding,
                                       suppressed)

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_COND_CTORS = {"threading.Condition"}
_POOL_CTORS = {"concurrent.futures.ThreadPoolExecutor",
               "futures.ThreadPoolExecutor", "ThreadPoolExecutor"}
_THREAD_CTORS = {"threading.Thread", "Thread"}

_MUTATORS = {"append", "appendleft", "add", "extend", "update", "remove",
             "discard", "pop", "popleft", "clear", "insert", "setdefault",
             "put"}
_BLOCKING = {"synchronize", "join", "shutdown", "result", "acquire", "run"}


def _self_attr(node) -> str | None:
    """'f' when node is ``self.f``."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassModel:
    def __init__(self, cls: ast.ClassDef, src: SourceFile):
        self.cls = cls
        self.src = src
        self.methods: dict[str, ast.AST] = {
            s.name: s for s in cls.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_fields: set[str] = set()
        self.cond_fields: set[str] = set()
        self.pool_fields: set[str] = set()
        self.entries: dict[str, str] = {}  # method -> context label
        self._scan_fields()
        self.threaded = bool(self.entries)

    def _scan_fields(self):
        for m in self.methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Call):
                    ctor = self.src.resolve(dotted(node.value.func))
                    for tgt in node.targets:
                        f = _self_attr(tgt)
                        if f is None:
                            continue
                        if ctor in _LOCK_CTORS:
                            self.lock_fields.add(f)
                        elif ctor in _COND_CTORS:
                            self.cond_fields.add(f)
                        elif ctor in _POOL_CTORS or ctor.endswith(
                                "ThreadPoolExecutor"):
                            self.pool_fields.add(f)
                if isinstance(node, ast.Call):
                    ctor = self.src.resolve(dotted(node.func))
                    if ctor in _THREAD_CTORS or ctor.endswith(
                            "threading.Thread"):
                        for kw in node.keywords:
                            if kw.arg == "target":
                                t = _self_attr(kw.value)
                                if t:
                                    self.entries[t] = f"thread:{t}"
                    elif (isinstance(node.func, ast.Attribute)
                          and node.func.attr == "submit"
                          and _self_attr(node.func.value)
                          in self.pool_fields and node.args):
                        t = _self_attr(node.args[0])
                        if t:
                            self.entries[t] = f"pool:{t}"

    @property
    def guard_fields(self) -> set[str]:
        return self.lock_fields | self.cond_fields


def _callees(method: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(method):
        if isinstance(node, ast.Call):
            t = _self_attr(node.func)
            if t:
                out.add(t)
    return out


def check_source(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            model = _ClassModel(node, src)
            if model.threaded and model.guard_fields:
                findings.extend(_check_class(model))
    return findings


def _check_class(model: _ClassModel) -> list[Finding]:
    src, methods = model.src, model.methods
    callgraph = {name: _callees(m) & set(methods) for name, m in
                 methods.items()}
    callers: dict[str, set[str]] = {name: set() for name in methods}
    for caller, callees in callgraph.items():
        for c in callees:
            callers[c].add(caller)

    # ---- thread contexts (fixpoint over the intra-class call graph) --
    ctx: dict[str, set[str]] = {name: set() for name in methods}
    for name in methods:
        if name in model.entries:
            ctx[name].add(model.entries[name])
        elif not callers[name] or not name.startswith("_"):
            # externally callable (public or uncalled) => caller thread
            ctx[name].add("main")
    for _ in range(len(methods)):
        changed = False
        for name in methods:
            if name in model.entries:
                continue
            inherited = set()
            for c in callers[name]:
                inherited |= ctx[c]
            if not inherited <= ctx[name]:
                ctx[name] |= inherited
                changed = True
        if not changed:
            break

    # ---- per-statement lock-held positions ---------------------------
    def _with_holds(w: ast.With) -> bool:
        return any(_self_attr(item.context_expr) in model.guard_fields
                   for item in w.items)

    held_nodes: dict[str, set[ast.AST]] = {}
    for name, m in methods.items():
        held: set[ast.AST] = set()
        # every descendant of a lock-holding With's body is lock-held
        for sub in ast.walk(m):
            if isinstance(sub, ast.With) and _with_holds(sub):
                for stmt in sub.body:
                    for n in ast.walk(stmt):
                        held.add(n)
                    held.add(stmt)
        held_nodes[name] = held

    # ---- held-context propagation: a private method whose every call
    # site is under the lock runs lock-held itself ---------------------
    held_methods: set[str] = set()
    for _ in range(2):
        for name, m in methods.items():
            if name in held_methods or name in model.entries:
                continue
            if not name.startswith("_") or name == "__init__":
                continue
            sites = []
            for caller in callers[name]:
                cm = methods[caller]
                for sub in ast.walk(cm):
                    if isinstance(sub, ast.Call) and (
                            _self_attr(sub.func) == name):
                        sites.append(sub in held_nodes[caller]
                                     or caller in held_methods)
            if sites and all(sites):
                held_methods.add(name)

    def _is_held(name: str, node: ast.AST) -> bool:
        return name in held_methods or node in held_nodes[name]

    # ---- shared fields ----------------------------------------------
    writes: dict[str, list[tuple[str, ast.AST]]] = {}

    def _note_write(field, name, node):
        if field and field not in model.guard_fields and name != "__init__":
            writes.setdefault(field, []).append((name, node))

    for name, m in methods.items():
        for sub in ast.walk(m):
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                tgts = sub.targets if isinstance(sub, ast.Assign) else (
                    [sub.target])
                for tgt in tgts:
                    base = tgt
                    while isinstance(base, (ast.Subscript, ast.Attribute)):
                        f = _self_attr(base)
                        if f:
                            _note_write(f, name, sub)
                            break
                        base = base.value
            elif isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and sub.func.attr in _MUTATORS:
                recv = sub.func.value
                while isinstance(recv, (ast.Subscript, ast.Attribute)):
                    f = _self_attr(recv)
                    if f:
                        _note_write(f, name, sub)
                        break
                    recv = recv.value

    shared = {f for f, ws in writes.items()
              if len({c for (n, _) in ws for c in ctx[n]}) >= 2}

    findings: list[Finding] = []

    def _report(rule, node, qualname, message):
        if not suppressed(rule, src, node, qualname):
            findings.append(finding(rule, src, node, message))

    cname = model.cls.name

    # L001: shared field mutated without the lock
    for field in sorted(shared):
        for name, node in writes[field]:
            if not _is_held(name, node):
                _report("L001", node, f"{cname}.{name}",
                        f"shared field self.{field} (written from contexts "
                        f"{sorted(set(c for n, _ in writes[field] for c in ctx[n]))}) "
                        f"mutated in {name}() without holding the lock.")

    # L002/L003
    for name, m in methods.items():
        for sub in ast.walk(m):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if not isinstance(f, ast.Attribute):
                continue
            recv_field = _self_attr(f.value)
            if (f.attr == "wait" and recv_field in model.cond_fields
                    and not _is_held(name, sub)):
                _report("L002", sub, f"{cname}.{name}",
                        f"self.{recv_field}.wait() without the lock held: "
                        "Condition.wait requires the associated lock.")
            if (f.attr in _BLOCKING and recv_field not in model.guard_fields
                    and _is_held(name, sub)):
                _report("L003", sub, f"{cname}.{name}",
                        f".{f.attr}() (blocking) inside a with-lock body in "
                        f"{name}(): holding the lock across a blocking call "
                        "serializes the pipeline. Capture refs under the "
                        "lock, call outside it.")
    return findings
