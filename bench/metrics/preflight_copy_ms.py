"""``preflight_copy_ms``: host milliseconds per window call in the
program's span ``preflight.copy`` (``core/preflight.py::_host``: the
edges' three pageable copies from the card to the host, each a
``d2h.preflight`` read), from the program's own record
(``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.span_ms(run, "preflight.copy")
