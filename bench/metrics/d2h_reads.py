"""``d2h_reads``: reads of the card by the host per window call, the
program's counter ``d2h.reads`` (every ``d2h.<site>`` span: the
preflight copies, each greedy round, BFS layer and MCM phase, the
window depth, the finish), from its own record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.per_call(run, "d2h.reads")
