"""R002 — a host clock, host RNG or host sync inside a captured region.

A CUDA graph replays the device work its capture recorded, and nothing
of the host: ``time.*``, ``random.*`` or an unseeded ``np.random.*``
read during the capture is frozen into the graph's operands (or never
reaches it), and ``torch.rand*`` without ``generator=`` draws from the
global generator, whose state a replay does not advance as the eager
loop would.  A host sync (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize()``, an event's
``.synchronize()``) is refused by the capture ("operation not permitted
when stream is capturing") — on the card only, so a CPU run never shows
it.

Captured regions: the body of ``with torch.cuda.graph(...)``; the lines
between a ``.capture_begin(...)`` and the next ``.capture_end()`` of the
same function; and the step functions handed to the executor's captured
programs — the step, ``step_residual=`` and ``residual_fn=`` of
``History(...)`` and the body of ``_capture(...)``, ``_Program(...)``,
when they are a def of the same module (with the defs nested in it) or a
lambda.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule, call_name, dotted, last_name

_RANDOM_OK = {"numpy.random.default_rng", "numpy.random.Generator",
              "numpy.random.SeedSequence", "numpy.random.PCG64"}
_TORCH_RNG = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
              "torch.rand_like", "torch.randn_like", "torch.randint_like",
              "torch.normal", "torch.bernoulli", "torch.multinomial"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_GRAPH_CTX = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
# (callee's last name) -> (the positional and keyword arguments it runs
# captured)
_CAPTURED_ARGS = {"History": ((0,), ("step_residual", "residual_fn")),
                  "_capture": ((0,), ()), "_Program": ((0,), ())}


class R002CapturedHost(Rule):
    id = "R002"
    title = "host clock/RNG/sync inside a captured region"

    def on_module(self, tree: ast.Module):
        defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        regions: list[tuple[ast.AST, str]] = []      # (node, what)
        spans: list[tuple[int, int, str]] = []       # (first, last, what)
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and self.src.resolve(
                            call_name(ctx)) in _GRAPH_CTX:
                        regions += [(stmt, "a torch.cuda.graph body")
                                    for stmt in node.body]
            elif isinstance(node, ast.Call):
                spec = _CAPTURED_ARGS.get(last_name(node))
                if spec is None:
                    continue
                pos, kws = spec
                args = [node.args[i] for i in pos if i < len(node.args)]
                args += [k.value for k in node.keywords if k.arg in kws]
                for arg in args:
                    if isinstance(arg, ast.Lambda):
                        regions.append((arg.body, f"a lambda handed to "
                                                  f"{last_name(node)}()"))
                    elif isinstance(arg, ast.Name):
                        regions += [(fn, f"{arg.id!r}, handed to "
                                         f"{last_name(node)}()")
                                    for fn in defs.get(arg.id, ())]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spans += self._capture_spans(node)
        seen: set[int] = set()
        for region, what in regions:
            for sub in ast.walk(region):
                if isinstance(sub, ast.Call) and id(sub) not in seen:
                    seen.add(id(sub))
                    self._check(sub, what)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and id(node) not in seen:
                for first, last, what in spans:
                    if first < node.lineno < last:
                        seen.add(id(node))
                        self._check(node, what)
                        break

    @staticmethod
    def _capture_spans(fn) -> list:
        """(the line of each ``.capture_begin(``, the line of the next
        ``.capture_end(`` in ``fn``)."""
        calls = sorted((n.lineno, n.func.attr) for n in ast.walk(fn)
                       if isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Attribute)
                       and n.func.attr in ("capture_begin", "capture_end"))
        spans = []
        for i, (line, attr) in enumerate(calls):
            if attr == "capture_begin":
                end = next((ln for ln, a in calls[i + 1:]
                            if a == "capture_end"), None)
                if end is not None:
                    spans.append((line, end, f"the capture in {fn.name!r}"))
        return spans

    def _check(self, node: ast.Call, what: str):
        name = self.src.resolve(call_name(node))
        bad = None
        if name.startswith(("time.", "datetime.", "random.")):
            bad = f"host clock/RNG {name}()"
        elif name.startswith("numpy.random.") and name not in _RANDOM_OK:
            bad = f"unseeded host RNG {name}()"
        elif name in _TORCH_RNG and not any(k.arg == "generator"
                                            for k in node.keywords):
            bad = f"{name}() without generator="
        elif name == "torch.cuda.synchronize" or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
                and dotted(node.func.value) not in ("torch", "np",
                                                    "numpy")):
            bad = f"host sync .{last_name(node)}()"
        if bad:
            self.report(node, f"{bad} inside {what}: a captured region "
                              "replays device work only (a host value is "
                              "frozen at capture; a host sync is refused "
                              "by the capture, on the card). Hoist it out "
                              "of the captured step.")
