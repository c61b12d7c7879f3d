"""The plain torch version of K4 (the counterpart of the JAX package's
``kernels/router_swap/ref.py``): it materialises the [T, T] gain matrix.

For token j with expert e_j and current affinity cur[j], the gain of
swapping experts with token i is

    W[i, j] = ((aff[i, e_j] + aff[j, e_i]) - cur[i]) - cur[j]

(the reference's order of additions), -inf where i == j or e_i == e_j.
The result is the column max and the smallest row reaching it, or -1
where the column has no finite entry. ``router_swap_plain`` takes one
group ([T, E]); ``router_swap_plain_batched`` takes G groups ([G, T, E]),
which never swap with each other.
"""
from __future__ import annotations

import torch

NEG = float("-inf")
INT32_MAX = torch.iinfo(torch.int32).max


def router_swap_plain_batched(affinity, assign, cur):
    """affinity [G, T, E] float32; assign [G, T] integer; cur [G, T]
    float32. Returns (gain [G, T] float32, partner [G, T] int32)."""
    g, t, _ = affinity.shape
    idx = assign.long()
    # a[g, i, j] = aff[g, i, e_j]
    a = torch.gather(affinity, 2, idx[:, None, :].expand(g, t, t))
    w = a + a.transpose(1, 2) - cur[:, :, None] - cur[:, None, :]
    tok = torch.arange(t, device=affinity.device)
    same = (idx[:, :, None] == idx[:, None, :]) | (tok[:, None] == tok)[None]
    w = w.masked_fill(same, NEG)
    gain = w.amax(dim=1)
    hit = (w == gain[:, None, :]) & (gain > NEG)[:, None, :]
    rows = torch.where(hit, tok[None, :, None], INT32_MAX).amin(dim=1)
    return gain, torch.where(gain > NEG, rows, -1).to(torch.int32)


def router_swap_plain(affinity, assign, cur):
    """One group: affinity [T, E], assign [T], cur [T]."""
    gain, partner = router_swap_plain_batched(affinity[None], assign[None],
                                              cur[None])
    return gain[0], partner[0]
