"""Swap-gain search of the AWPM MoE router, K4: the wrapper of the CUDA
kernel ``csrc/router_swap.cu`` over G independent groups.

For every token j, its best swap partner i: ``W[i, j] = ((aff[i, e_j] +
aff[j, e_i]) - cur[i]) - cur[j]``, excluding the same token and the same
expert; the column max, the smallest row on a tie, -1 where there is none
(``ref.py``).

A CUDA tensor always goes to the kernel, or the wrapper raises; a CPU
tensor goes to the plain version ``router_swap_plain_batched``, which the
tests hold to the JAX reference and the chip check holds the kernel to.
Unlike the TPU kernel, the CUDA kernel takes any T and any E up to
``MAX_EXPERTS``, and ``assign`` as int32 or int64, so nothing is padded
or cast.

A ``meta`` tensor launches nothing: the wrapper returns the kernel's
outputs as ``meta`` tensors and adds the kernel's work
(``roofline.analysis.swap_work``) to an open ``kernel_work`` counter, as
a launch adds it. The ids cannot be read there, so the pairs are counted
for an assignment as even as T and E allow (``balanced_counts``), which
every assignment of the AWPM router's rounds is. Nothing is counted as a
launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.router_swap.ref import router_swap_plain_batched
from repro_torch.roofline.analysis import (
    balanced_counts,
    count_kernel_work,
    counting_kernel_work,
    swap_work,
)

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

#: the kernel stages a row tile of [64, E] affinities per buffer
MAX_EXPERTS = 256
_INDEX_TYPES = (torch.int32, torch.int64)


def _check_inputs(affinity, assign, cur):
    if affinity.dim() != 3:
        raise ValueError(f"expected affinity [G, T, E], got "
                         f"{tuple(affinity.shape)}")
    g, t, e = affinity.shape
    want = {"affinity": (affinity, (torch.float32,), (g, t, e)),
            "assign": (assign, _INDEX_TYPES, (g, t)),
            "cur": (cur, (torch.float32,), (g, t))}
    for name, (x, dtypes, shape) in want.items():
        if (x.device != affinity.device or x.dtype not in dtypes
                or tuple(x.shape) != shape):
            raise ValueError(
                f"{name}: expected {' or '.join(map(str, dtypes))} {shape} "
                f"on {affinity.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    if t < 1 or not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"T={t} must be at least 1 and E={e} in [1, "
                         f"{MAX_EXPERTS}]")


def router_swap(affinity, assign, cur):
    """affinity [G, T, E] float32; assign [G, T] int32 or int64 (expert ids
    in [0, E)); cur [G, T] float32. Returns (gain [G, T] float32, partner
    [G, T] int32)."""
    _check_inputs(affinity, assign, cur)
    if affinity.device.type == "cpu":
        return router_swap_plain_batched(affinity, assign, cur)
    if affinity.device.type == "meta":
        return _meta(affinity, assign)
    return _launch(affinity, assign, cur)


def _outputs(affinity):
    g, t, _ = affinity.shape
    return (torch.empty((g, t), dtype=torch.float32, device=affinity.device),
            torch.empty((g, t), dtype=torch.int32, device=affinity.device))


def _meta(affinity, assign):
    """The kernel's outputs on ``meta``, and its work counted."""
    g, t, e = affinity.shape
    count_kernel_work("router_swap",
                      *swap_work(assign, e, balanced_counts(g, t, e)))
    return _outputs(affinity)


def _launch(affinity, assign, cur):
    global launches
    if affinity.device.type != "cuda":
        raise ValueError(f"router_swap runs on a CUDA device, got "
                         f"{affinity.device}")
    g, t, e = affinity.shape
    ins = [x.contiguous() for x in (affinity, assign, cur)]
    gain, partner = _outputs(affinity)
    lib = backend.library()
    stream = torch.cuda.current_stream(affinity.device).cuda_stream
    err = lib.router_swap(*(x.data_ptr() for x in ins), gain.data_ptr(),
                          partner.data_ptr(), g, t, e,
                          int(assign.dtype == torch.int64), stream)
    launches += 1
    backend.check(err, "router_swap")
    if counting_kernel_work():
        count_kernel_work("router_swap", *swap_work(assign, e))
    return gain, partner
