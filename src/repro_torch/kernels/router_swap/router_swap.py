"""Swap-gain search of the AWPM MoE router, K4: the wrapper of the CUDA
kernel ``csrc/router_swap.cu`` over G independent groups.

For every token j, its best swap partner i: ``W[i, j] = ((aff[i, e_j] +
aff[j, e_i]) - cur[i]) - cur[j]``, excluding the same token and the same
expert; the column max, the smallest row on a tie, -1 where there is none
(``ref.py``).

A CUDA tensor always goes to the kernel, or the wrapper raises; a CPU
tensor goes to the plain version ``router_swap_plain_batched``, which the
tests hold to the JAX reference and the chip check holds the kernel to.
As with the TPU kernel, T must be a multiple of the tile (64 here) and E
of 4: ``ops.router_swap_padded_batched`` pads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.router_swap.ref import router_swap_plain_batched

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

#: T must be a multiple of TILE, E of E_ALIGN and at most MAX_EXPERTS
TILE = 64
E_ALIGN = 4
MAX_EXPERTS = 256


def _check_inputs(affinity, assign, cur):
    if affinity.dim() != 3:
        raise ValueError(f"expected affinity [G, T, E], got "
                         f"{tuple(affinity.shape)}")
    g, t, e = affinity.shape
    want = {"affinity": (affinity, torch.float32, (g, t, e)),
            "assign": (assign, torch.int32, (g, t)),
            "cur": (cur, torch.float32, (g, t))}
    for name, (x, dtype, shape) in want.items():
        if (x.device != affinity.device or x.dtype != dtype
                or tuple(x.shape) != shape):
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {affinity.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if t % TILE or e % E_ALIGN or not E_ALIGN <= e <= MAX_EXPERTS:
        raise ValueError(f"T={t} must be a multiple of {TILE} and E={e} a "
                         f"multiple of {E_ALIGN} in [{E_ALIGN}, "
                         f"{MAX_EXPERTS}] (ops.router_swap_padded_batched "
                         "pads)")


def router_swap(affinity, assign, cur):
    """affinity [G, T, E] float32; assign [G, T] int32 (expert ids in
    [0, E)); cur [G, T] float32. Returns (gain [G, T] float32, partner
    [G, T] int32)."""
    _check_inputs(affinity, assign, cur)
    if affinity.device.type == "cpu":
        return router_swap_plain_batched(affinity, assign, cur)
    return _launch(affinity, assign, cur)


def _launch(affinity, assign, cur):
    global launches
    if affinity.device.type != "cuda":
        raise ValueError(f"router_swap runs on a CUDA device, got "
                         f"{affinity.device}")
    g, t, e = affinity.shape
    ins = [x.contiguous() for x in (affinity, assign, cur)]
    gain = torch.empty((g, t), dtype=torch.float32, device=affinity.device)
    partner = torch.empty((g, t), dtype=torch.int32, device=affinity.device)
    lib = backend.library()
    stream = torch.cuda.current_stream(affinity.device).cuda_stream
    err = lib.router_swap(*(x.data_ptr() for x in ins), gain.data_ptr(),
                          partner.data_ptr(), g, t, e, stream)
    launches += 1
    backend.check(err, "router_swap")
    return gain, partner
