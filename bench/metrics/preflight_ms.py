"""``preflight_ms``: host milliseconds per call in the program's input
screen, ``repro_torch.core.preflight.preflight`` (the edges copied to the
host and scanned in numpy), which ``api.solve`` runs on every call."""

SPAN = "preflight"
WRAPS = (("repro_torch.core.preflight", "preflight"),)


def read(run):
    return run.span_ms(SPAN)
