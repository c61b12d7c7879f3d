"""``device_idle``: the share of the traced window, in percent, in which no
kernel, copy or fill ran on the card. Nothing where the trace saw no
device operation."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
