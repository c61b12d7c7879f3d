"""The whole AWAC loop for a batch of instances: the wrapper of the
cooperative CUDA kernel ``csrc/awac_persistent.cu`` and its plain torch
version.

Each round, per instance: the sweep (Steps A+B+C, ``awac_sweep``); Step D,
where every e2 column keeps the rooted column j with the largest gain (the
smallest j on a tie); the survivors (an unrooted e2 column keeps its j);
the single-best-cycle fallback when nothing survives; the reference's
eight augmentation writes; and the convergence test ``n_surv > 0`` under
``max_iter``. ``go0`` [B] gates instances out from round 0.

Returns (mate_row, mate_col, u, v [B, n + 1], iters [B] int32), per
instance bit-identical to ``core.single._awac_loop`` on any backend.

A CUDA tensor always goes to the kernel; a CPU tensor goes to the plain
version, the torch engine's own loop (``core.batch``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.cycle_gain.awac_sweep import (
    _check_inputs,
    device_scalar,
)
from repro_torch.sparse.ops import INT32_MAX

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

_I32 = torch.int32


def awac_persistent_batched(row, col, val, row_ptr, mate_row, mate_col, u, v,
                            min_gain, go0, *, n: int, window_steps: int,
                            max_iter: int):
    """The AWAC loop over B instances. The inputs are not modified."""
    _check_inputs(row, col, val, row_ptr, mate_row, mate_col, u, v, n)
    b = row.shape[0]
    if go0.shape != (b,) or go0.device != row.device:
        raise ValueError(f"go0: expected [{b}] on {row.device}, got "
                         f"{tuple(go0.shape)} on {go0.device}")
    if row.device.type == "cpu":
        return awac_persistent_plain(row, col, val, row_ptr, mate_row,
                                     mate_col, u, v, min_gain, go0, n=n,
                                     window_steps=window_steps,
                                     max_iter=max_iter)
    return _launch(row, col, val, row_ptr, mate_row, mate_col, u, v,
                   min_gain, go0, n, max_iter)


def _launch(row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, go0,
            n, max_iter):
    global launches
    if row.device.type != "cuda":
        raise ValueError(f"awac_persistent runs on a CUDA device, got "
                         f"{row.device}")
    b, cap = row.shape
    dev = row.device
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (row, col, val, row_ptr, mate_row, mate_col, u, v)]
    go = (go0 if go0.dtype == torch.bool else go0 != 0).contiguous()
    mg = device_scalar(min_gain, dev)
    lib = backend.library()
    # the kernel copies the state in and writes the final state and the
    # rounds here, each array 16-byte aligned; it sets its scratch itself
    size = b * (n + 1)
    stride = -(-size // 4) * 4
    out = torch.empty(4 * stride + b, dtype=_I32, device=dev)
    state = [out[k * stride:k * stride + size].view(b, n + 1)
             for k in range(4)]
    state[2:] = [x.view(torch.float32) for x in state[2:]]
    iters = out[4 * stride:]
    nbytes = lib.awac_persistent_scratch_bytes(b, n)
    scratch = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=dev)
    # the launch is asynchronous on torch's current stream; tensors freed
    # when this returns go back to the caching allocator, which hands
    # their memory out again only to work ordered after the kernel
    err = lib.awac_persistent(
        *(x.data_ptr() for x in ins), go.data_ptr(), mg.data_ptr(),
        int(min(max(max_iter, 0), INT32_MAX)), b, cap, n,
        *(x.data_ptr() for x in state), iters.data_ptr(), scratch.data_ptr(),
        scratch.numel() * 8, backend.stream(dev))
    launches += 1
    backend.check(err, "awac_persistent")
    return (*state, iters)


def awac_persistent_plain(row, col, val, row_ptr, mate_row, mate_col, u, v,
                          min_gain, go0, *, n: int, window_steps: int,
                          max_iter: int):
    """The loop in plain torch: the torch engine's masked batched loop
    (``core.batch.awac_loop`` over its fused sweep), gated by ``go0``."""
    # imported here: core.batch reaches this module through cycle_gain.ops
    from repro_torch.core.batch import awac_cwinners_fused_batched, awac_loop
    from repro_torch.core.single import MatchState

    def cwinners(st):
        return (*awac_cwinners_fused_batched(row, col, val, row_ptr, n, st,
                                             min_gain, window_steps), 0)

    state, iters, _ = awac_loop(n, MatchState(mate_row, mate_col, u, v),
                                max_iter, cwinners,
                                active0=go0.to(torch.bool))
    return (*state, iters)
