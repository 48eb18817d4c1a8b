"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs every portlint rule (R001-R009) and the lock-discipline checker
(L001-L003) over ``paths`` (default: ``src/repro_torch`` and
``chip_smoke.py``) and prints each finding as ``path:line:col: RULE
message``.  Exit status 1 when anything fires.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint import DEFAULT_PATHS, lint_paths
from repro_torch.analysis.rules import ALL_RULES

LOCK_RULES = (("L001", "shared field mutated without the lock"),
              ("L002", "Condition.wait without the lock held"),
              ("L003", "blocking call inside a with-lock body"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="portlint: the port's contract lints + lock checker")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--no-locks", action="store_true",
                    help="skip the lock-discipline checker")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id}  {cls.title}")
        for rid, title in LOCK_RULES:
            print(f"{rid}  {title}")
        return 0

    rules = None
    if args.rules:
        want = {r.strip() for r in args.rules.split(",")}
        rules = [cls for cls in ALL_RULES if cls.id in want]

    findings = lint_paths(args.paths or None, rules=rules,
                          include_locks=not args.no_locks)
    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        n = len(findings)
        print(f"portlint: {n} finding(s)" if n else "portlint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
