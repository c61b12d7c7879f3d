"""The engines' entry points into the AWAC kernels: B=1 slices and the
mapping of the sweep's sentinels to the engines' winner contract.

The CUDA kernels mask the ragged tail of the edge list themselves, so no
padding of the edge arrays to a tile size is needed here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cycle_gain.awac_sweep import awac_sweep_batched
from repro_torch.kernels.cycle_gain.persistent import awac_persistent_batched
from repro_torch.sparse.ops import NEG


def awac_sweep_winners_batched(row, col, val, row_ptr, mate_row, mate_col, u,
                               v, min_gain, *, n: int, window_steps: int):
    """Steps A+B+C of one round via the sweep kernel. Same contract as
    ``core.batch.awac_cwinners_fused_batched``: (Cgain [B, n], Ci [B, n]
    (sentinel n if no candidate), Cw1, Cw2), bit-identical to it."""
    Cgain, Crow, Cw1, Cw2 = awac_sweep_batched(
        row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, n=n,
        window_steps=window_steps)
    has = Cgain > NEG
    Ci = torch.where(has, Crow, n)
    return Cgain, Ci, torch.where(has, Cw1, 0.0), torch.where(has, Cw2, 0.0)


def awac_sweep_winners(row, col, val, row_ptr, mate_row, mate_col, u, v,
                       min_gain, *, n: int, window_steps: int):
    """Single-instance ``awac_sweep_winners_batched``: the [n] winners
    ``core.single.awac_cwinners`` returns."""
    out = awac_sweep_winners_batched(
        row[None], col[None], val[None], row_ptr[None], mate_row[None],
        mate_col[None], u[None], v[None], min_gain, n=n,
        window_steps=window_steps)
    return tuple(x[0] for x in out)


def awac_persistent_loop_batched(row, col, val, row_ptr, mate_row, mate_col,
                                 u, v, min_gain, go0, *, n: int,
                                 window_steps: int, max_iter: int):
    """The whole AWAC loop of B instances in one kernel launch. Returns
    (mate_row, mate_col, u, v [B, n + 1], iters [B])."""
    return awac_persistent_batched(
        row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain,
        go0.reshape(-1).to(torch.bool), n=n, window_steps=window_steps,
        max_iter=max_iter)


def awac_persistent_loop(row, col, val, row_ptr, mate_row, mate_col, u, v,
                         min_gain, go0, *, n: int, window_steps: int,
                         max_iter: int):
    """Single-instance persistent loop: state [n + 1] and a scalar
    iteration count."""
    mr, mc, uu, vv, it = awac_persistent_loop_batched(
        row[None], col[None], val[None], row_ptr[None], mate_row[None],
        mate_col[None], u[None], v[None], min_gain,
        torch.as_tensor(go0, device=row.device).reshape(1), n=n,
        window_steps=window_steps, max_iter=max_iter)
    return mr[0], mc[0], uu[0], vv[0], it[0]
