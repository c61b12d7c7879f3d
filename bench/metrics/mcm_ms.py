"""``mcm_ms``: host milliseconds per call in the maximum cardinality
matching, ``repro_torch.core.single.mcm`` (cold calls): its phases of
layered BFS, each layer one read of the device."""

SPAN = "mcm"
WRAPS = (("repro_torch.core.single", "mcm"),)


def read(run):
    return run.span_ms(SPAN)
