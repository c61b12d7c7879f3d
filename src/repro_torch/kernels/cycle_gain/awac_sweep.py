"""AWAC sweep (Steps A+B+C of one round) for a batch of instances: the
wrapper of the CUDA kernel ``csrc/awac_sweep.cu`` and its plain torch
version.

Per edge (i, j) of every instance:
  A: the completion edge (m_j, m_i) of the 4-cycle, by a binary search
     inside row m_j's CSR segment of the lex-sorted edge list;
  B: the gain ``w1 + w2 - u[i] - v[j]`` and the candidate mask
     ``found & i < n & i > m_j & gain > min_gain``;
  C: the per-column winner: max gain, the smaller row on a tie, with its
     w1 and w2.

Returns (Cgain, Crow, Cw1, Cw2), each [B, n]; a column without a
candidate holds (-inf, INT32_MAX, 0, 0). ``ops.awac_sweep_winners_batched``
maps those sentinels to the engines' contract.

A CUDA tensor always goes to the kernel; a CPU tensor goes to the plain
version, the torch engine's own sweep (``core.batch``), which the tests
hold to the reference and the chip check holds the kernel to.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.sparse.ops import INT32_MAX, NEG

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

_I32, _F32 = torch.int32, torch.float32


def _check_inputs(row, col, val, row_ptr, mate_row, mate_col, u, v, n):
    b, cap = row.shape
    want = {
        "row": (row, _I32, (b, cap)), "col": (col, _I32, (b, cap)),
        "val": (val, _F32, (b, cap)), "row_ptr": (row_ptr, _I32, (b, n + 2)),
        "mate_row": (mate_row, _I32, (b, n + 1)),
        "mate_col": (mate_col, _I32, (b, n + 1)),
        "u": (u, _F32, (b, n + 1)), "v": (v, _F32, (b, n + 1)),
    }
    dev = row.device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def awac_sweep_batched(row, col, val, row_ptr, mate_row, mate_col, u, v,
                       min_gain, *, n: int, window_steps: int):
    """One AWAC sweep over B instances. ``min_gain`` is a float32 scalar;
    ``window_steps`` sizes the plain version's fixed-depth search (the
    kernel searches until its window closes)."""
    _check_inputs(row, col, val, row_ptr, mate_row, mate_col, u, v, n)
    if row.device.type == "cpu":
        return awac_sweep_plain(row, col, val, row_ptr, mate_row, mate_col,
                                u, v, min_gain, n=n,
                                window_steps=window_steps)
    return _launch(row, col, val, row_ptr, mate_row, mate_col, u, v,
                   min_gain, n)


def _launch(row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, n):
    global launches
    if row.device.type != "cuda":
        raise ValueError(f"awac_sweep runs on a CUDA device, got {row.device}")
    b, cap = row.shape
    ins = [x.contiguous() for x in (row, col, val, row_ptr, mate_row,
                                    mate_col, u, v)]
    dev = row.device
    keys = torch.empty((b, n), dtype=torch.int64, device=dev)
    cgain = torch.empty((b, n), dtype=_F32, device=dev)
    crow = torch.empty((b, n), dtype=_I32, device=dev)
    cw1 = torch.empty((b, n), dtype=_F32, device=dev)
    cw2 = torch.empty((b, n), dtype=_F32, device=dev)
    lib = backend.library()
    # the launch is asynchronous on torch's current stream; tensors freed
    # when this returns go back to the caching allocator, which hands
    # their memory out again only to work ordered after the kernel
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.awac_sweep(*(x.data_ptr() for x in ins), float(min_gain), b,
                         cap, n, keys.data_ptr(), cgain.data_ptr(),
                         crow.data_ptr(), cw1.data_ptr(), cw2.data_ptr(),
                         stream)
    launches += 1
    backend.check(err, "awac_sweep")
    return cgain, crow, cw1, cw2


def awac_sweep_plain(row, col, val, row_ptr, mate_row, mate_col, u, v,
                     min_gain, *, n: int, window_steps: int):
    """The sweep in plain torch: the torch engine's fused Steps A+B+C,
    with a column without a candidate mapped to the kernel's sentinels."""
    # imported here: core.batch reaches this module through cycle_gain.ops
    from repro_torch.core.batch import awac_cwinners_fused_batched
    from repro_torch.core.single import MatchState

    Cgain, Ci, Cw1, Cw2 = awac_cwinners_fused_batched(
        row, col, val, row_ptr, n, MatchState(mate_row, mate_col, u, v),
        min_gain, window_steps)
    return Cgain, torch.where(Cgain > NEG, Ci, INT32_MAX), Cw1, Cw2
