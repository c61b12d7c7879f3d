"""``solve_ms``: the measured window's length over the calls it
completed, in milliseconds. Each call makes its values, solves, and ends
with the caller holding its permutation after a device sync."""


def read(run):
    if not run.completed:
        return None
    return 1e3 * run.window_s / run.completed
