"""Padded entry points of K4 (the counterpart of the JAX package's
``kernels/router_swap/ops.py``).

They pad with the JAX wrapper's rules: a padded token has zero affinity,
expert id ``E`` (distinct from every real id) and ``cur = +inf``, which
drives every gain that involves it to exactly -inf; a padded expert column
is zero. Never pad with -inf: -inf + -inf - ... gives NaN, which would
poison the column max. T is padded to a multiple of the kernel's tile and
E to a multiple of 4 above ``E`` (so that the padded id names a zero
column, as the TPU wrapper's lane padding does). ``use_kernel=False``
takes the dense plain version on the unpadded inputs, as JAX's
``use_kernel=False`` takes ``router_swap_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.router_swap.ref import (
    router_swap_plain,
    router_swap_plain_batched,
)
from repro_torch.kernels.router_swap.router_swap import (
    E_ALIGN,
    TILE,
    router_swap,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_for_kernel(affinity, assign, cur):
    """affinity [G, T, E], assign [G, T], cur [G, T] padded with the rules
    above to the kernel's shapes: ([G, Tp, Ep] float32, [G, Tp] int32,
    [G, Tp] float32)."""
    g, t, e = affinity.shape
    tp, ep = _round_up(t, TILE), _round_up(e + 1, E_ALIGN)
    dev = affinity.device
    aff = torch.zeros((g, tp, ep), dtype=torch.float32, device=dev)
    aff[:, :t, :e] = affinity
    as_p = torch.full((g, tp), e, dtype=torch.int32, device=dev)
    as_p[:, :t] = assign
    cur_p = torch.full((g, tp), float("inf"), dtype=torch.float32,
                       device=dev)
    cur_p[:, :t] = cur
    return aff, as_p, cur_p


def router_swap_padded_batched(affinity, assign, cur, *,
                               use_kernel: bool = True):
    """affinity [G, T, E] float32; assign [G, T] integer; cur [G, T]
    float32. Returns (gain [G, T] float32, partner [G, T] int32)."""
    if not use_kernel:
        return router_swap_plain_batched(affinity, assign, cur)
    t = affinity.shape[1]
    gain, partner = router_swap(*pad_for_kernel(affinity, assign, cur))
    return gain[:, :t], partner[:, :t]


def router_swap_padded(affinity, assign, cur, *, use_kernel: bool = True):
    """One group: affinity [T, E], assign [T], cur [T]."""
    if not use_kernel:
        return router_swap_plain(affinity, assign, cur)
    gain, partner = router_swap_padded_batched(affinity[None], assign[None],
                                               cur[None])
    return gain[0], partner[0]
