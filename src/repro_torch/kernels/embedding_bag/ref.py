"""The plain torch version of K6 (the counterpart of the JAX package's
``kernels/embedding_bag/ref.py``): gather, then a weighted sum.

``out[b] = sum_l w[b, l] * table[idx[b, l]]``, where an index below 0 is
padding (weight 0) and an index at or above V reads row V - 1, as the
reference clips it. The JAX package's Pallas kernel gives such an index
no row at all (it meets only the zero padding of its vocabulary tiles);
the port follows the reference's clip in both its plain version and its
kernel (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import torch


def embedding_bag_plain(idx, w, table):
    """idx [B, L] integer (-1 padding); w [B, L]; table [V, D] -> [B, D]
    float32."""
    safe = idx.long().clamp(0, table.shape[0] - 1)
    rows = table[safe].float()  # [B, L, D]
    wm = torch.where(idx >= 0, w, 0.0).float()
    return (rows * wm[:, :, None]).sum(dim=1)
