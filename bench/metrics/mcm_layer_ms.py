"""``mcm_layer_ms``: host milliseconds of one BFS layer, the mean of the
program's ``mcm.layer`` spans in the window: the layer's launches and
its read of the device (``d2h.mcm_layer``), which waits for the layer's
device work. The batched engine (``batch.mcm_bfs_loop``) opens one a
layer over all its lanes; the single-instance engine on the card runs
its layers inside the MCM kernel and opens none. From the program's own
record (``bench/program.py``)."""
from bench import program

program.arm()


def read(run):
    return program.mean_ms(run, "mcm.layer")
