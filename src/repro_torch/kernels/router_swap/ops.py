"""Entry points of K4 under the names of the JAX package's
``kernels/router_swap/ops.py``.

The JAX wrapper pads T and E to the TPU kernel's tiles (a padded token
with zero affinity, expert id ``E`` and ``cur = +inf``, so that every gain
involving it is exactly -inf). The CUDA kernel takes any T and E and an
int32 or int64 ``assign`` as they are, so these entries pad nothing and
make one launch; they keep the JAX names because ``models/moe.py`` and the
tests call them where JAX calls its padded entries. ``use_kernel=False``
takes the dense plain version, as JAX's ``use_kernel=False`` takes
``router_swap_ref``.
"""
from __future__ import annotations

from repro_torch.kernels.router_swap.ref import (
    router_swap_plain,
    router_swap_plain_batched,
)
from repro_torch.kernels.router_swap.router_swap import router_swap


def router_swap_padded_batched(affinity, assign, cur, *,
                               use_kernel: bool = True):
    """affinity [G, T, E] float32; assign [G, T] int32 or int64; cur [G, T]
    float32. Returns (gain [G, T] float32, partner [G, T] int32)."""
    if not use_kernel:
        return router_swap_plain_batched(affinity, assign, cur)
    return router_swap(affinity, assign, cur)


def router_swap_padded(affinity, assign, cur, *, use_kernel: bool = True):
    """One group: affinity [T, E], assign [T], cur [T]."""
    if not use_kernel:
        return router_swap_plain(affinity, assign, cur)
    gain, partner = router_swap(affinity[None], assign[None], cur[None])
    return gain[0], partner[0]
