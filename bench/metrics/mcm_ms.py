"""``mcm_ms``: host milliseconds per call in the maximum cardinality
matching (cold calls): ``repro_torch.core.single.mcm`` for one matrix
(on the card one launch of the MCM kernel) and
``repro_torch.core.batch.mcm_loop`` for a batch, its phases of layered
BFS over every lane in lockstep, each layer one read of the device."""

SPAN = "mcm"
WRAPS = (("repro_torch.core.single", "mcm"),
         ("repro_torch.core.batch", "mcm_loop"))


def read(run):
    return run.span_ms(SPAN)
