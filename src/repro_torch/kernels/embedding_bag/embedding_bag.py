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

The kernel has two routes, and ``plan_route`` picks one, with its
parameters, from (B, L, V, D) and the card's SM count; nothing else
chooses. Route A (few bags) cuts each bag into slices so that the grid
fills the card; route B (many bags) sorts each bag's entries by window of
the table and sweeps the windows, which the L2 cache holds, with the
bags' sums in shared memory (the source says how). Either route is one
launch a call (route B also clears a 4-byte counter), and ``launches``
counts it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

#: the table's width must be a multiple of D_ALIGN (float4 rows)
D_ALIGN = 4

#: route B: table bytes a window holds at most (its rows are a power of
#: two). The L2 keeps about 32 MB of gathered rows hot, and windows of
#: 32 MiB were the fastest of 16 to 64 MiB on an H100 (PERF.md, K6)
WINDOW_BYTES = 32 * 2**20
#: route B: one block of SWEEP_WARPS warps per SM (80 registers a thread),
#: which keeps the sums of its bags in SWEEP_SMEM bytes of shared memory
#: (its sort's counters take 3 KB more, within the 227 KB a block may
#: have); at most MAX_WINDOWS windows (a lane counts each)
SWEEP_WARPS = 24
SWEEP_SMEM = 220 * 1024
MAX_WINDOWS = 32
#: route A: slices a bag (a power of two, at most MAX_SLICES: the warps of
#: a block) until the grid holds SLICE_WARPS_PER_SM warps an SM: 4 at
#: serve_p99, the fastest of 1 to 8 there on an H100 (PERF.md, K6)
SLICE_WARPS_PER_SM = 8
MAX_SLICES = 8
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class BagPlan:
    """How the kernel runs one call: ``route`` "A" (``slices`` warps a
    bag) or "B" (``windows`` windows of ``window_rows`` table rows,
    ``passes`` passes of ``bags_per_block`` bags over ``blocks`` blocks);
    the dynamic shared memory of a block and the scratch the wrapper
    allocates."""
    route: str
    slices: int
    windows: int
    window_rows: int
    passes: int
    bags_per_block: int
    blocks: int
    smem_bytes: int
    scratch_bytes: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def plan_route(b: int, l: int, v: int, d: int, sms: int | None = None
               ) -> BagPlan:
    """The route and its parameters for B bags of L entries over a
    [V, D] float32 table on a card of ``sms`` SMs (read from the current
    CUDA device when None).

    Route B when there are many bags, at least one for each warp of its
    grid (``sms * SWEEP_WARPS``: 3,168 on an H100) and at least one bag's
    sums fit each warp's share of shared memory; route A otherwise. Route
    B sweeps windows of the largest power of two of rows within
    WINDOW_BYTES (more when MAX_WINDOWS would not cover the table; one
    window, with no sort, when the table fits it) in as few passes as the
    shared memory allows, balanced over the blocks."""
    if sms is None:
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    row_bytes = 4 * d  # a row of the table, and a bag's float32 sums
    rows = 1 << max(0, (WINDOW_BYTES // row_bytes).bit_length() - 1)
    rows = max(rows, _pow2_at_least(math.ceil(v / MAX_WINDOWS)))
    windows = math.ceil(v / rows)
    if windows == 1:
        rows = _pow2_at_least(v)
    most = SWEEP_SMEM // row_bytes
    if b >= sms * SWEEP_WARPS and most >= SWEEP_WARPS:
        passes = math.ceil(b / (sms * most))
        nb = math.ceil(b / (passes * sms))
        if nb * l > INT32_MAX:
            raise ValueError(f"embedding_bag: {nb} bags of {l} entries a "
                             "block overflow the kernel's int32 offsets")
        scratch = 16  # the window counter
        if windows > 1:  # the segment offsets, then the sorted entries
            offsets = 4 * sms * nb * (windows + 1)
            scratch += 16 * math.ceil(offsets / 16) + 8 * sms * nb * l
        return BagPlan("B", 1, windows, rows, passes, nb, sms,
                       nb * row_bytes, scratch)
    slices = 1
    cap = min(MAX_SLICES, 1 << (max(1, l).bit_length() - 1))
    while slices < cap and b * slices < sms * SLICE_WARPS_PER_SM:
        slices *= 2
    per_block = MAX_SLICES // slices
    return BagPlan("A", slices, 1, v, 1, per_block,
                   math.ceil(b / per_block), 0, 0)


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


def _launch(idx, w, table, plan: BagPlan | None = None, split=None):
    """Launch the kernel on CUDA tensors under ``plan`` (by default
    ``plan_route``'s). ``split``, an int64 [blocks, 4] CUDA tensor, takes
    route B's nanoseconds per block in its sort, wait, walk and write
    phases (a measurement's argument; the entry passes none)."""
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
    if plan is None:
        plan = plan_route(b, l, v, d, torch.cuda.get_device_properties(
            table.device).multi_processor_count)
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                           device=table.device) if plan.scratch_bytes else None)
    lib = backend.library()
    err = lib.embedding_bag(
        idx.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), b, l,
        v, d, 0 if plan.route == "A" else 1, plan.slices, plan.windows,
        plan.window_rows, plan.passes, plan.bags_per_block, plan.blocks,
        plan.smem_bytes,
        None if scratch is None else scratch.data_ptr(),
        None if split is None else split.data_ptr(),
        backend.stream(table.device))
    launches += 1
    backend.check(err, "embedding_bag")
    return out
