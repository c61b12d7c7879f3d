"""``mcm_layers``: BFS layers per window call over all of MCM's phases,
the program's counter ``mcm.layers`` (``single._mcm_bfs``,
``batch.mcm_bfs_loop``: one read of the device a layer), from its own
record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.per_call(run, "mcm.layers")
