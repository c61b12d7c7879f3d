"""The entry of K6 (the counterpart of the JAX package's
``kernels/embedding_bag/ops.py``), with its signature.

The JAX wrapper padded B to its bag tile and V to its vocabulary tile;
the CUDA kernel takes any B, L and V, so nothing is padded here. Wider
indices are cast to int32 (after a clip to [-1, V], which keeps their
meaning) and the weights to float32, the types the kernel reads (the TPU
kernel read the same). ``use_kernel=False`` takes
the plain version, as JAX's takes ``embedding_bag_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain


def embedding_bag_padded(idx, w, table, *, use_kernel: bool = True):
    """idx [B, L] integer (-1 = padding); w [B, L]; table [V, D] float32.
    Returns [B, D] float32."""
    if not use_kernel:
        return embedding_bag_plain(idx, w, table)
    if table.shape[0] > torch.iinfo(torch.int32).max:
        raise ValueError(f"a table of {table.shape[0]} rows overflows the "
                         "kernel's int32 indices")
    if idx.dtype != torch.int32:
        idx = idx.clamp(min=-1, max=table.shape[0]).to(torch.int32)
    return embedding_bag(idx, w.to(torch.float32), table)
