"""``warm_state_ms``: host milliseconds per call in the warm engine's
phases before AWAC, ``repro_torch.core.batch._warm_state_batched``: the
seed repaired against the edges, the MCM top-up, the duals."""

SPAN = "warm_state"
WRAPS = (("repro_torch.core.batch", "_warm_state_batched"),)


def read(run):
    return run.span_ms(SPAN)
