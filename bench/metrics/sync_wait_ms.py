"""``sync_wait_ms``: host milliseconds per window call inside the
program's ``d2h.*`` spans, the host blocked on reads of the card (the
preflight copies included), from its own record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.wait_ms(run)
