"""``greedy_ms``: host milliseconds per call in the greedy maximal
matching (cold calls): ``repro_torch.core.single.greedy_maximal`` for one
matrix, ``repro_torch.core.batch.greedy_loop`` for a batch, its proposal
rounds over every lane in lockstep."""

SPAN = "greedy"
WRAPS = (("repro_torch.core.single", "greedy_maximal"),
         ("repro_torch.core.batch", "greedy_loop"))


def read(run):
    return run.span_ms(SPAN)
