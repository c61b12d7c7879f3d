#!/usr/bin/env python3
"""Run a Python script with every line it prints stamped with the seconds
since the start, to find where a long run spends its time.

The gap between a line and the next is the time spent after the first.
Only ``print`` to standard output is stamped; standard error is left as
it is.

    python3 tools/stamp_lines.py chip_smoke.py [ARGS ...]
    python3 tools/stamp_lines.py chip_smoke.py | python3 tools/stamp_lines.py --gaps 2
"""
from __future__ import annotations

import builtins
import runpy
import sys
import time


def gaps(least: float) -> int:
    """Read stamped lines on standard input; print each line after which
    at least ``least`` seconds passed, longest first."""
    rows, prev = [], None
    for line in sys.stdin:
        head = line.split(None, 1)
        try:
            t = float(head[0])
        except (IndexError, ValueError):
            continue
        if prev is not None and t - prev[0] >= least:
            rows.append((t - prev[0], prev[1]))
        prev = (t, line.rstrip("\n"))
    for dt, line in sorted(rows, reverse=True):
        print(f"{dt:7.1f} s after: {line[:200]}")
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--gaps"]:
        return gaps(float(argv[1]))
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    plain = builtins.print

    def stamped(*args, **kwargs):
        out = kwargs.get("file")
        if out is None or out is sys.stdout:
            plain(f"{time.perf_counter() - t0:8.1f}", *args, **kwargs)
        else:
            plain(*args, **kwargs)

    builtins.print = stamped
    sys.argv = list(argv)
    sys.path.insert(0, ".")
    try:
        runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None
                                                        else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
