"""``setup_s``: seconds from the process's start to the window's: imports,
CUDA's start, loading (at a checkout's first run, building) the kernel
library, the pattern made on the device, and the mix's warm-up calls."""


def read(run):
    return run.setup_s
