"""``greedy_rounds``: greedy proposal rounds per window call, the
program's counter ``greedy.rounds`` (``single.greedy_maximal``,
``batch.greedy_loop``: one read of the device a round), from its own
record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.per_call(run, "greedy.rounds")
