"""Every MCM phase of one instance: the wrapper of the cooperative CUDA
kernel ``csrc/mcm_persistent.cu``.

From a matching (``mate_row``, ``mate_col`` [n + 1], sentinel n), phases
of a layered BFS from the free columns (each reached row's parent the
heaviest edge into the frontier, the first in edge order on a tie),
then the lockstep trace of the augmenting paths found and the flip of the
survivors, while a column is free and the last phase found a path.

Returns (mate_row, mate_col [n + 1] int32, stats [3] int64: phases, BFS
layers, 1 when a column is still free), bit-identical to
``core.single.mcm_plain``'s mates, phases, layers and free flag. CUDA
tensors only: ``core.single.mcm`` sends everything else to
``mcm_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.cycle_gain.awac_sweep import MAX_CAP

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

_I32 = torch.int32


def _check_inputs(row, col, val, row_ptr, mate_row, mate_col, n):
    dev = row.device
    e, s = tuple(row.shape), (n + 1,)
    for name, x, dtype, shape in (
            ("row", row, _I32, e), ("col", col, _I32, e),
            ("val", val, torch.float32, e), ("row_ptr", row_ptr, _I32,
                                             (n + 2,)),
            ("mate_row", mate_row, _I32, s), ("mate_col", mate_col, _I32, s)):
        if x.dtype != dtype or x.shape != shape or x.device != dev:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if len(e) != 1 or e[0] >= MAX_CAP:
        raise ValueError(f"the edges must be one instance's [cap] with cap < "
                         f"2**31, got {e}")


def mcm_persistent(row, col, val, row_ptr, mate_row, mate_col, *, n: int):
    """Every MCM phase from the given matching, in one launch on the
    inputs' CUDA device. The inputs are not modified."""
    global launches
    _check_inputs(row, col, val, row_ptr, mate_row, mate_col, n)
    dev = col.device
    if dev.type != "cuda":
        raise ValueError(f"mcm_persistent runs on a CUDA device, got {dev}")
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (col, val, row_ptr, mate_row, mate_col)]
    lib = backend.library()
    # the kernel copies the matching in and writes the final one here,
    # each array 16-byte aligned; it sets its scratch itself
    stride = -(-(n + 1) // 4) * 4
    out = torch.empty(2 * stride, dtype=_I32, device=dev)
    mr, mc = out[:n + 1], out[stride:stride + n + 1]
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    nbytes = lib.mcm_persistent_scratch_bytes(n)
    scratch = torch.empty((nbytes + 15) // 16 * 2, dtype=torch.int64,
                          device=dev)
    # asynchronous on torch's current stream; memory freed when this
    # returns is handed out again only to work ordered after the kernel
    err = lib.mcm_persistent(
        *(x.data_ptr() for x in ins), n, mr.data_ptr(), mc.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), scratch.numel() * 8,
        backend.stream(dev))
    launches += 1
    backend.check(err, "mcm_persistent")
    return mr, mc, stats

