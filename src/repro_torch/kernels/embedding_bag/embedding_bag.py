"""EmbeddingBag, K6: the wrapper of the CUDA kernel
``csrc/embedding_bag.cu``.

``out[b] = sum_l w[b, l] * table[idx[b, l]]`` over bags of any length L,
with index -1 (any index below 0) as padding and an index at or above V
clipped to row V - 1, as the plain version ``ref.embedding_bag_plain``
clips it.

A CUDA tensor always goes to the kernel, or the wrapper raises; a CPU
tensor goes to the plain version, which the tests hold to the JAX
reference and the chip check holds the kernel to. The kernel takes any
B, L and V (the TPU kernel needed B a multiple of 8 and V of its
vocabulary tile), a float32 table whose width D is a multiple of 4, int32
indices and float32 weights.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

#: the table's width must be a multiple of D_ALIGN (float4 rows)
D_ALIGN = 4


def _check_inputs(idx, w, table):
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"expected idx [B, L] and table [V, D], got "
                         f"{tuple(idx.shape)} and {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise ValueError(f"embedding_bag takes a float32 table, got "
                         f"{table.dtype}: no path needs another yet "
                         "(ROADMAP.md, Queue 2, K6)")
    v, d = table.shape
    b, l = idx.shape
    want = {"idx": (idx, torch.int32), "w": (w, torch.float32)}
    for name, (x, dtype) in want.items():
        if (x.device != table.device or x.dtype != dtype
                or tuple(x.shape) != (b, l)):
            raise ValueError(
                f"{name}: expected {dtype} {(b, l)} on {table.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if d % D_ALIGN or d == 0 or v == 0:
        raise ValueError(f"table [{v}, {d}]: D must be a positive multiple "
                         f"of {D_ALIGN} and V positive")


def embedding_bag(idx, w, table):
    """idx [B, L] int32 (-1 = padding); w [B, L] float32; table [V, D]
    float32. Returns [B, D] float32."""
    _check_inputs(idx, w, table)
    if table.device.type == "cpu":
        return embedding_bag_plain(idx, w, table)
    return _launch(idx, w, table)


def _launch(idx, w, table):
    global launches
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on a CUDA device, got "
                         f"{table.device}")
    b, l = idx.shape
    v, d = table.shape
    idx, w, table = (x.contiguous() for x in (idx, w, table))
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (float4 rows)")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    lib = backend.library()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.embedding_bag(idx.data_ptr(), w.data_ptr(), table.data_ptr(),
                            out.data_ptr(), b, l, v, d, stream)
    launches += 1
    backend.check(err, "embedding_bag")
    return out
