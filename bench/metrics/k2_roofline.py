"""``k2_roofline``: kernel K2's share of its roofline, in percent: the
least time the AWAC loop's bytes and operations for the window's rounds
could take on the card (``bench.peaks``) over K2's device time in the
trace. Nothing where the trace holds no K2 launch."""

from bench import peaks

#: the kernel symbol of K2 (``kernels/csrc/awac_persistent.cu``)
KERNEL = "awac_loop_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds_of(KERNEL)
    if t <= 0 or not run.rounds:
        return None
    nbytes, ops = peaks.loop_bytes(run.nnz, run.n, run.rounds)
    return 100.0 * peaks.bound_s(nbytes, ops) / t
