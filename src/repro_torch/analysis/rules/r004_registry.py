"""R004 — registry completeness, with the hooks ``api.Solver`` defines.

A ``@register``-ed solver provides the lifecycle the drivers, the store
and the servers call (``prepare``/``init``/``step``/``extract``).  A
solver that opts into the mesh backend (its chain implements
``mesh_placements``, ``mesh_prepare`` or ``mesh_step``, the hooks
``api.Solver`` leaves as stubs) has the whole mesh surface
(``mesh_placements``, ``mesh_factors``, ``mesh_prepare``, ``mesh_init``,
``mesh_step``): a partial one fails at placement, after the first
collective, on every rank.  A solver whose chain declares
``supports_redundancy = True`` or implements ``red_init``/``red_step``
has the whole redundant surface (``red_factors``, ``red_init``,
``red_step``, ``red_expand``, ``red_collapse``, ``red_factor_placements``,
``red_state_placements``).  Inheritance is resolved across every
scanned file (``api.Solver``'s defaults count; its stubs, a body of one
``raise NotImplementedError``, do not).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (Finding, ProgramRule, SourceFile,
                                       class_table, dotted, inherited)

LIFECYCLE = ("prepare", "init", "step", "extract")
MESH_FULL = ("mesh_placements", "mesh_factors", "mesh_prepare", "mesh_init",
             "mesh_step")
RED_FULL = ("red_factors", "red_init", "red_step", "red_expand",
            "red_collapse", "red_factor_placements", "red_state_placements")
# the hooks whose implementation opts a solver in (api.Solver's stubs)
MESH_OPT_IN = ("mesh_placements", "mesh_prepare", "mesh_step")
RED_OPT_IN = ("red_init", "red_step")


def _registered_name(cls: ast.ClassDef) -> str | None:
    for dec in cls.decorator_list:
        if isinstance(dec, ast.Call) and (
                (dotted(dec.func) or "").split(".")[-1] == "register"):
            if dec.args and isinstance(dec.args[0], ast.Constant):
                return str(dec.args[0].value)
            return cls.name
    return None


class R004RegistryComplete(ProgramRule):
    id = "R004"
    title = "@register-ed solver missing lifecycle/mesh/redundant hooks"

    def run_program(self, sources: list[SourceFile]) -> list[Finding]:
        table = class_table(sources)
        findings: list[Finding] = []
        for src in sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                reg = _registered_name(node)
                if reg is None:
                    continue
                defined, attrs, _ = inherited(node, table)

                def need(hooks, why):
                    missing = [h for h in hooks if h not in defined]
                    if missing:
                        self.report_at(
                            src, node, f"registered solver {reg!r} "
                            f"missing {missing}: {why}", node.name,
                            findings)

                need(LIFECYCLE, "the drivers, the store and the servers "
                                "call prepare/init/step/extract.")
                if defined & set(MESH_OPT_IN):
                    need(MESH_FULL, "a mesh hook implies the whole mesh "
                                    "surface, else placement fails after "
                                    "the first collective.")
                red = attrs.get("supports_redundancy")
                if defined & set(RED_OPT_IN) or (
                        isinstance(red, ast.Constant) and red.value is True):
                    need(RED_FULL, "redundant execution calls the whole "
                                   "red_* surface.")
        return findings
