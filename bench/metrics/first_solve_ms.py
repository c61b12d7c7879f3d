"""``first_solve_ms``: host milliseconds of the process's first
``solve()`` (the first set-up call: first launches, allocations and
caches), the program's first ``solve`` root span, from its own record
(``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.first_ms(run)
