"""The central allow-list of portlint.

Every sanctioned exception to a rule lives here with its reason, so an
audit of what is exempt and why is one file.  An entry is ``(path_glob,
qualname_glob, why)``: a finding is dropped when its repo-relative path
matches ``path_glob`` (fnmatch, or a suffix) and its qualified name
(``Class.method``, ``""`` at module scope) matches ``qualname_glob``.

A one-line exception prefers the inline ``# repro: allow[RULE]`` beside
the line; this file is for structural ones, whole functions or classes
whose job is what the rule contains.
"""
from __future__ import annotations

ALLOW: dict[str, tuple[tuple[str, str, str], ...]] = {
    # R001: a capture built inside a function.  The rule catches a graph
    # made per call; these are the owners that capture ONCE and replay.
    "R001": (
        ("src/repro_torch/solvers/executor.py", "_capture",
         "the one constructor of a CUDAGraph: each call captures the graph "
         "of one program, which its owner keeps and replays"),
        ("src/repro_torch/solvers/executor.py", "_Program.*",
         "a captured program: constructing it is its one capture"),
        ("src/repro_torch/solvers/executor.py", "_Loop.*",
         "a static-buffer chunk loop: its program is built with it, once"),
        ("src/repro_torch/solvers/executor.py", "run_history",
         "a one-shot history: ONE CHUNK-step graph a call, replayed "
         "(T - CHUNK) // CHUNK times and freed on return; the reference "
         "likewise compiles its history once per CompiledSolve"),
        ("src/repro_torch/solvers/executor.py", "StepProgram.*",
         "builds its one step program at its first run, replays it at "
         "every later step of every run"),
        ("src/repro_torch/solvers/executor.py", "LocalExecutor.*",
         "the keyed program cache of serving: one program a (cold/warm, "
         "placement, batch shape) key, built at that key's first run"),
        ("src/repro_torch/solvers/redundant.py", "RedundantEngine.*",
         "one step program an engine, made at construction and replayed "
         "for every segment (the elastic runtime keeps one engine a fleet "
         "size)"),
        ("src/repro_torch/solvers/mesh.py", "RedundantRunner.*",
         "the mesh twin of RedundantEngine: one step program a runner"),
        ("chip_smoke.py", "phases.graphed",
         "a measurement: one 10-step graph captured per timed variant, "
         "before its timing loop"),
    ),
    # R006: a device selector outside device.py.
    "R006": (
        ("src/repro_torch/kernels/ops.py", "_device",
         "the reference's public use_fused/pick_tiles take no device: "
         "without one a verdict is for where the kernels would run, the "
         "card when there is one (the reference's 'compiled where the "
         "hardware is'); every solver path passes its operand's device"),
        ("chip_smoke.py", "main",
         "the chip check must refuse, and print no result, without a "
         "card: its one question of the host, before anything runs"),
    ),
}
