"""``awac_ms``: host milliseconds per call in the AWAC loop, the cold
path's ``repro_torch.core.single.awac`` or the warm path's
``repro_torch.core.batch.awac_batched`` (on the card "auto" runs the
whole loop in kernel K2)."""

SPAN = "awac"
WRAPS = (("repro_torch.core.single", "awac"),
         ("repro_torch.core.batch", "awac_batched"))


def read(run):
    return run.span_ms(SPAN)
