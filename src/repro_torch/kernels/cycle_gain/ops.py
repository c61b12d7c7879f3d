"""The public entries of the cycle-gain kernels (the counterpart of the
JAX package's ``kernels/cycle_gain/ops.py``): the dense tile K3
(``cycle_gain_padded``, ``swap_gains``), and the engines' entry points
into the AWAC kernels K1 and K2, B=1 slices and the mapping of the
sweep's sentinels to the engines' winner contract.

The CUDA kernels take any shape (K3 any M and N; K1 and K2 mask the
ragged tail of the edge list themselves), so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cycle_gain.awac_sweep import awac_sweep_batched
from repro_torch.kernels.cycle_gain.cycle_gain import cycle_gain
from repro_torch.kernels.cycle_gain.persistent import awac_persistent_batched
from repro_torch.kernels.cycle_gain.ref import cycle_gain_plain
from repro_torch.sparse.ops import NEG


def cycle_gain_padded(a, a2, u, v, *, use_kernel: bool = True):
    """The dense cycle-gain tile: K3 on CUDA tensors, its plain version on
    CPU tensors, and the plain version with ``use_kernel=False`` (as JAX's
    takes ``cycle_gain_ref``). a, a2 [M, N] float32 (0.0 = absent); u [M];
    v [N]. Returns (gain [N] float32, row [N] int32, -1 where no
    candidate)."""
    if not use_kernel:
        return cycle_gain_plain(a, a2, u, v)
    return cycle_gain(a, a2, u, v)


def swap_gains(affinity, assign_expert, tok_affinity, *,
               use_kernel: bool = True):
    """The AWPM router's swap gains through the dense cycle-gain contract,
    as the JAX package's ``swap_gains`` computes them: ``A[i, j] =
    affinity[i, assign_expert[j]]``, ``A2 = A.T`` and ``u = v =
    tok_affinity``. Returns each token j's best partner gain [T] and row
    [T].

    Reproduced as the reference has it, unlike K4 (``router_swap``): the
    same token and the same expert are not excluded (their gain is
    exactly 0, so they can win a column that has no positive swap), and
    an affinity of exactly 0.0 counts as absent (ROADMAP.md, Queue 3)."""
    a = affinity[:, assign_expert.long()]  # [T, T]: aff[i, e_j]
    return cycle_gain_padded(a, a.T.contiguous(), tok_affinity, tok_affinity,
                             use_kernel=use_kernel)


def awac_sweep_winners_batched(row, col, val, row_ptr, mate_row, mate_col, u,
                               v, min_gain, *, n: int, window_steps: int,
                               scratch=None):
    """Steps A+B+C of one round via the sweep kernel. Same contract as
    ``core.batch.awac_cwinners_fused_batched``: (Cgain [B, n], Ci [B, n]
    (sentinel n if no candidate), Cw1, Cw2), bit-identical to it.
    ``scratch`` (``awac_sweep.SweepScratch``) keeps the kernel's row
    records from one round to the next."""
    Cgain, Crow, Cw1, Cw2 = awac_sweep_batched(
        row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, n=n,
        window_steps=window_steps, scratch=scratch)
    has = Cgain > NEG
    Ci = torch.where(has, Crow, n)
    return Cgain, Ci, torch.where(has, Cw1, 0.0), torch.where(has, Cw2, 0.0)


def awac_sweep_winners(row, col, val, row_ptr, mate_row, mate_col, u, v,
                       min_gain, *, n: int, window_steps: int,
                       scratch=None):
    """Single-instance ``awac_sweep_winners_batched``: the [n] winners
    ``core.single.awac_cwinners`` returns."""
    out = awac_sweep_winners_batched(
        row[None], col[None], val[None], row_ptr[None], mate_row[None],
        mate_col[None], u[None], v[None], min_gain, n=n,
        window_steps=window_steps, scratch=scratch)
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
