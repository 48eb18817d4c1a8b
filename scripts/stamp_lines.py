#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since the first
read, flushing every line: where a long run's wall time goes, line by
line, e.g.

    python3 -u chip_smoke.py 2>&1 | python3 -u scripts/stamp_lines.py > run.log

A line's number is when it arrived, so the gap before it is the time
its work took (stderr interleaved as the pipe delivers it)."""
import sys
import time


def main() -> int:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
