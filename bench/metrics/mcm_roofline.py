"""``mcm_roofline``: the MCM kernel's share of its roofline, in percent:
the least time the bytes and operations any BFS must move and do for the
window's phases and layers could take on the card (``bench.peaks``
``mcm_bytes`` at 3.35 TB/s) over the device time of ``mcm_kernel`` in the
trace. The phases and layers are the program's counters ``mcm.phases``
and ``mcm.layers`` of the window's calls that ran the kernel (counter
``mcm.kernel``), from its own record (``bench/program.py``). Nothing
where the trace holds no ``mcm_kernel`` launch."""
from bench import peaks, program

program.arm()

#: the kernel symbol (``kernels/csrc/mcm_persistent.cu``)
KERNEL = "mcm_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds_of(KERNEL)
    s = program.split(run)
    if t <= 0 or s is None:
        return None
    ran = [c for c in s.window.counts.values() if c.get("mcm.kernel")]
    if not ran:
        return None
    nbytes, ops = peaks.mcm_bytes(
        run.nnz, run.n, sum(c.get("mcm.phases", 0) for c in ran),
        sum(c.get("mcm.layers", 0) for c in ran), len(ran))
    return 100.0 * peaks.bound_s(nbytes, ops) / t
