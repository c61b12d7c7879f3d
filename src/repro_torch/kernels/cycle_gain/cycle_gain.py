"""Dense cycle-gain tile, K3: the wrapper of the CUDA kernel
``csrc/cycle_gain.cu``.

For every column j of the dense tile: ``W[i, j] = ((a[i, j] + a2[i, j]) -
u[i]) - v[j]`` where both a and a2 are present (non-zero), else -inf; the
column max, and the smallest row reaching it, or -1 where there is none
(``ref.py``).

A CUDA tensor always goes to the kernel, or the wrapper raises; a CPU
tensor goes to the plain version ``cycle_gain_plain``, which the tests
hold to the JAX reference and the chip check holds the kernel to, bit for
bit. The kernel takes any M and N (the TPU kernel needed multiples of its
tiles).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.cycle_gain.ref import cycle_gain_plain

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0


def _check_inputs(a, a2, u, v):
    if a.dim() != 2:
        raise ValueError(f"expected a [M, N], got {tuple(a.shape)}")
    m, n = a.shape
    want = {"a": (a, (m, n)), "a2": (a2, (m, n)), "u": (u, (m,)),
            "v": (v, (n,))}
    for name, (x, shape) in want.items():
        if (x.device != a.device or x.dtype != torch.float32
                or tuple(x.shape) != shape):
            raise ValueError(
                f"{name}: expected float32 {shape} on {a.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if m > torch.iinfo(torch.int32).max:
        raise ValueError(f"{m} rows overflow the int32 row index")


def cycle_gain(a, a2, u, v):
    """a, a2 [M, N] float32 (0.0 = absent); u [M] float32; v [N] float32.
    Returns (gain [N] float32, row [N] int32)."""
    _check_inputs(a, a2, u, v)
    if a.device.type == "cpu":
        return cycle_gain_plain(a, a2, u, v)
    return _launch(a, a2, u, v)


def _launch(a, a2, u, v):
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"cycle_gain runs on a CUDA device, got {a.device}")
    m, n = a.shape
    ins = [x.contiguous() for x in (a, a2, u, v)]
    gain = torch.empty(n, dtype=torch.float32, device=a.device)
    row = torch.empty(n, dtype=torch.int32, device=a.device)
    if n == 0:
        return gain, row
    lib = backend.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.cycle_gain(*(x.data_ptr() for x in ins), gain.data_ptr(),
                         row.data_ptr(), m, n, stream)
    launches += 1
    backend.check(err, "cycle_gain")
    return gain, row
