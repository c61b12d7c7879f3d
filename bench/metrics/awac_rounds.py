"""``awac_rounds``: AWAC rounds per call, the mean of the results'
``awac_iters`` over the window's completed calls."""


def read(run):
    if not run.rounds:
        return None
    return sum(run.rounds) / len(run.rounds)
