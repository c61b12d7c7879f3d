"""``greedy_ms``: host milliseconds per call in the greedy maximal
matching, ``repro_torch.core.single.greedy_maximal`` (cold calls)."""

SPAN = "greedy"
WRAPS = (("repro_torch.core.single", "greedy_maximal"),)


def read(run):
    return run.span_ms(SPAN)
