"""``preflight_scan_ms``: host milliseconds per window call in the
program's span ``preflight.scan`` (``core/preflight.py::preflight``: the
numpy masks, the int64 key sort and the two ``bincount``s over the host
copies), from the program's own record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.span_ms(run, "preflight.scan")
