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

The rounds of one AWAC loop sweep the same edges, so a loop passes one
``SweepScratch`` to all of its calls: the first builds the row records
the kernel's lookups read, and the later ones reuse them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.sparse.ops import INT32_MAX, NEG

#: launches of the CUDA kernel since the last ``backend.reset_launch_counts``
launches = 0

_I32, _F32 = torch.int32, torch.float32
#: edges an instance may hold: the kernels index them with an int32
MAX_CAP = 2**31


def _check_inputs(row, col, val, row_ptr, mate_row, mate_col, u, v, n):
    b, cap = row.shape
    dev = row.device
    e, s = (b, cap), (b, n + 1)
    for name, x, dtype, shape in (
            ("row", row, _I32, e), ("col", col, _I32, e),
            ("val", val, _F32, e), ("row_ptr", row_ptr, _I32, (b, n + 2)),
            ("mate_row", mate_row, _I32, s), ("mate_col", mate_col, _I32, s),
            ("u", u, _F32, s), ("v", v, _F32, s)):
        if x.dtype != dtype or x.shape != shape or x.device != dev:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if cap >= MAX_CAP:
        # the kernels keep an edge's position inside its instance in the
        # low 32 bits of a column's winner key
        raise ValueError(f"cap {cap} >= 2**31: an instance's edge positions "
                         f"must fit an int32")


def device_scalar(x, dev) -> torch.Tensor:
    """``x`` as a float32 tensor on ``dev``, for a kernel that reads it
    there: no host sync for a value that already lives on the card."""
    if isinstance(x, torch.Tensor) and x.device == dev and x.dtype == _F32:
        return x
    return torch.as_tensor(x, dtype=_F32, device=dev)


def _tag(x) -> tuple:
    """What identifies a tensor's contents while it is alive: its address,
    shape and strides, and its version counter (shared by its views)."""
    return x.data_ptr(), x.shape, x.stride(), x._version


class SweepScratch:
    """The sweep kernel's scratch, kept across the calls of one AWAC loop:
    a 16-byte record per row (its CSR segment and column signature), which
    the edges alone fix, and an 8-byte key per column, which every call
    leaves zero. The first call on a CUDA tensor builds it; a call on
    other edges (``col`` or ``row_ptr`` elsewhere, or written since) builds
    it again. It holds the edges it was built from, so their memory cannot
    be handed to other tensors meanwhile. Calls that share one must run on
    one stream. A CPU call does not touch it."""

    __slots__ = ("buf", "edges")

    def __init__(self):
        self.buf = None    # int64 [3 * B * n]: records, then keys
        self.edges = None  # (col, row_ptr, their tags)

    def take(self, col, row_ptr, words: int):
        """(buffer, whether the call must build it, the edges' tags) for
        these edges. Until ``built`` marks it again, the buffer counts as
        unbuilt, so a call that fails leaves nothing for the next one to
        trust."""
        e, self.edges = self.edges, None
        tags = (_tag(col), _tag(row_ptr))
        if e is not None and self.buf.numel() == words and e[2] == tags:
            return self.buf, False, tags
        if self.buf is None or self.buf.numel() != words \
                or self.buf.device != col.device:
            self.buf = torch.empty(words, dtype=torch.int64,
                                   device=col.device)
        return self.buf, True, tags

    def built(self, col, row_ptr, tags) -> None:
        """Mark the buffer built from these edges (``take``'s tags: a
        launch writes neither, so their versions still hold)."""
        self.edges = (col, row_ptr, tags)


def awac_sweep_batched(row, col, val, row_ptr, mate_row, mate_col, u, v,
                       min_gain, *, n: int, window_steps: int,
                       scratch: SweepScratch | None = None):
    """One AWAC sweep over B instances. ``min_gain`` is a float32 scalar;
    ``window_steps`` sizes the plain version's fixed-depth search (the
    kernel searches until its window closes); ``scratch`` carries the
    kernel's row records from one call on these edges to the next."""
    _check_inputs(row, col, val, row_ptr, mate_row, mate_col, u, v, n)
    if row.device.type == "cpu":
        return awac_sweep_plain(row, col, val, row_ptr, mate_row, mate_col,
                                u, v, min_gain, n=n,
                                window_steps=window_steps)
    return _launch(row, col, val, row_ptr, mate_row, mate_col, u, v,
                   min_gain, n, scratch)


def _launch(row, col, val, row_ptr, mate_row, mate_col, u, v, min_gain, n,
            scratch):
    global launches
    if row.device.type != "cuda":
        raise ValueError(f"awac_sweep runs on a CUDA device, got {row.device}")
    b, cap = row.shape
    dev = row.device
    ins = [x if x.is_contiguous() else x.contiguous()
           for x in (row, col, val, row_ptr, mate_row, mate_col, u, v)]
    mg = device_scalar(min_gain, dev)
    # scratch: the row records (16 B a row, 16-byte aligned), then the keys
    if scratch is None:
        scratch = SweepScratch()
    buf, build, tags = scratch.take(col, row_ptr, 3 * b * n)
    rec = buf.data_ptr()
    # the four outputs in one allocation: each costs microseconds of host
    # time, against a kernel of about a hundred
    out = torch.empty((4, b, n), dtype=_I32, device=dev)
    cgain, _, cw1, cw2 = out.view(_F32).unbind()
    crow = out[1]
    o, step = out.data_ptr(), 4 * b * n
    lib = backend.library()
    # the launch is asynchronous on torch's current stream; tensors freed
    # when this returns go back to the caching allocator, which hands
    # their memory out again only to work ordered after the kernel
    err = lib.awac_sweep(*(x.data_ptr() for x in ins), mg.data_ptr(), b, cap,
                         n, rec, rec + 16 * b * n, int(build), o, o + step,
                         o + 2 * step, o + 3 * step, backend.stream(dev))
    launches += 1
    backend.check(err, "awac_sweep")
    scratch.built(col, row_ptr, tags)
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
