"""Segment-op primitives of the matching engines and of GNN message
passing, on torch tensors.

Padding convention: invalid entries carry ``segment_id == num_segments - 1``
(the dump segment ``n`` of an ``n + 1``-segment reduction) or are masked to
the reduction identity. Segment ids must lie in ``[0, num_segments)``.

Every reduction is an order-free max or min (``scatter_reduce`` with
``include_self=True`` onto an identity-filled tensor), so the results do
not depend on the order in which duplicates are combined — on the CPU or
on the card. Empty segments hold the identities of ``jax.ops.segment_*``:
``-inf`` for a float max, ``INT32_MAX`` for an int32 min.

Masked entries never reach a scatter in one heap: the engines mask most of
an edge list in most rounds, and atomics that all hit the dump segment's
one address serialize on the card. The max reductions leave ``-inf``
entries out (they can win nothing), and the walkers' ``segment_min`` sends
each entry that is not ``live`` to a slot of its own past the segments.
Leaving them out takes a count from the device (``nonzero``); on the
``meta`` device (the dry run's trace), where nothing can be read, every
entry is kept, the most a round can hold.

The GNN primitives (``segment_sum``, ``segment_max``, ``segment_argmax``,
``segment_softmax``, ``coo_spmm``, ``coo_sddmm``) reduce along the leading
axis of values of any rank and are differentiable. ``jax.ops.segment_sum``
drops ids outside ``[0, num_segments)``; ``index_add`` and
``scatter_reduce`` raise on them on the CPU and write out of bounds on the
card, so callers route padding to a sentinel segment that they slice off,
as the JAX package's GNN code does. A sum on the card adds in no fixed
order (atomics), so it differs from run to run at rounding level.
"""
from __future__ import annotations

import torch

from repro_torch import obs

NEG = float("-inf")
INT32_MAX = 2**31 - 1


def _identity_fill(n: int, like: torch.Tensor, op: str) -> torch.Tensor:
    if like.dtype.is_floating_point:
        fill = NEG if op == "amax" else float("inf")
    else:
        info = torch.iinfo(like.dtype)
        fill = info.min if op == "amax" else info.max
    return torch.full((n,), fill, dtype=like.dtype, device=like.device)


def segment_reduce(values, segment_ids, num_segments: int, op: str):
    """``jax.ops.segment_max`` (``op="amax"``) / ``segment_min``
    (``op="amin"``) over 1-D inputs."""
    out = _identity_fill(num_segments, values, op)
    return out.scatter_reduce(0, segment_ids.long(), values, op,
                              include_self=True)


def segment_min(values, segment_ids, num_segments: int, live=None):
    """``jax.ops.segment_min``. With a ``live`` mask, the result holds the
    live entries only: each other entry goes to a slot of its own past
    ``num_segments``, so no masked entry contends for a segment and no
    host read is needed to leave them out."""
    if live is None:
        return segment_reduce(values, segment_ids, num_segments, "amin")
    m = values.shape[0]
    spill = torch.arange(num_segments, num_segments + m, device=values.device)
    seg = torch.where(live, segment_ids.long(), spill)
    return segment_reduce(values, seg, num_segments + m, "amin")[:num_segments]


def _finite_entries(values):
    """The indices of the entries of ``values`` [m] above -inf (one host
    read for their count, span ``d2h.nonzero``); on ``meta``, every
    index."""
    if values.device.type == "meta":
        return torch.arange(values.shape[0], device=values.device)
    finite = values != NEG
    with obs.d2h("nonzero"):
        return finite.nonzero().squeeze(1)


def segment_max_with_payload(values, payload, segment_ids, num_segments: int):
    """Per-segment max of ``values`` and the smallest ``payload`` among the
    entries attaining it (the deterministic tie-break every engine shares).

    Two passes: a scatter-max of the values, then a scatter-min of the
    payload over the entries that hit their segment's max. Returns
    (seg_max [num_segments], seg_payload [num_segments] int32); segments
    with no entries, or whose max is -inf, get (-inf, -1). Entries of
    value -inf can win nothing and are left out of both scatters (one host
    read for their count)."""
    keep = _finite_entries(values)
    values, payload = values[keep], payload[keep]
    seg = segment_ids[keep].long()
    seg_max = segment_reduce(values, seg, num_segments, "amax")
    hit = values == seg_max[seg]
    cand = torch.where(hit, payload, INT32_MAX)
    seg_payload = segment_reduce(cand, seg, num_segments, "amin")
    seg_payload = torch.where(seg_max == NEG, -1, seg_payload)
    seg_payload = torch.where(seg_payload == INT32_MAX, -1, seg_payload)
    return seg_max, seg_payload


def _flat_segments(segment_ids, num_segments: int):
    """[B, m] per-instance segment ids -> flat ids over B * num_segments."""
    b = segment_ids.shape[0]
    offs = torch.arange(b, dtype=torch.int64,
                        device=segment_ids.device)[:, None] * num_segments
    return (segment_ids.long() + offs).reshape(-1)


def batched_segment_max_with_payload(values, payload, segment_ids,
                                     num_segments: int):
    """Batched ``segment_max_with_payload``: inputs are [B, m] with
    per-instance segments, reduced as ONE flat offset-segment reduction.
    Payloads stay local, so each instance gets exactly the winner of its
    own single-instance call. Returns ([B, num_segments], [B, num_segments])."""
    b = values.shape[0]
    seg_max, seg_payload = segment_max_with_payload(
        values.reshape(-1), payload.reshape(-1),
        _flat_segments(segment_ids, num_segments), b * num_segments)
    return (seg_max.reshape(b, num_segments),
            seg_payload.reshape(b, num_segments))


def batched_segment_min(values, segment_ids, num_segments: int, live=None):
    """Batched ``segment_min`` over per-instance segments, with the same
    ``live`` mask. Returns [B, num_segments]."""
    b = values.shape[0]
    out = segment_min(values.reshape(-1),
                      _flat_segments(segment_ids, num_segments),
                      b * num_segments,
                      live=None if live is None else live.reshape(-1))
    return out.reshape(b, num_segments)


def lex_searchsorted(keys_r, keys_c, q_r, q_c, n_steps: int = 32):
    """Fixed-depth binary search for the pairs (q_r, q_c) in the
    lexicographically sorted key pairs (keys_r, keys_c). Returns (pos,
    found): the insertion index and the exact-hit mask. ``n_steps=32``
    covers any int32-sized array."""
    m = keys_r.shape[0]
    lo = torch.zeros_like(q_r)
    hi = torch.full_like(q_r, m)
    for _ in range(n_steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mid_c = mid.clamp(0, m - 1).long()
        kr = keys_r[mid_c]
        kc = keys_c[mid_c]
        lt = (kr < q_r) | ((kr == q_r) & (kc < q_c))
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    pos_c = lo.clamp(0, m - 1).long()
    found = (lo < m) & (keys_r[pos_c] == q_r) & (keys_c[pos_c] == q_c)
    return lo, found


def searchsorted_in_window(keys, q, lo, hi, n_steps: int):
    """Per-query binary search for ``q`` inside the sorted window
    ``keys[lo:hi)``. ``n_steps`` must cover the widest window
    (``csr.window_depth`` of the max row degree). Returns (pos, found)."""
    m = keys.shape[0]
    hi0 = hi
    for _ in range(n_steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        k = keys[mid.clamp(0, m - 1).long()]
        lt = k < q
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    found = (lo < hi0) & (keys[lo.clamp(0, m - 1).long()] == q)
    return lo, found


def batched_searchsorted_in_window(keys, q, lo, hi, n_steps: int):
    """Batched ``searchsorted_in_window``: keys [B, m]; q/lo/hi [B, k] in
    per-instance coordinates. One flat search over B * m keys with each
    instance's windows offset by b * m. Returns (pos [B, k] local,
    found [B, k])."""
    b, m = keys.shape
    offs = torch.arange(b, dtype=lo.dtype, device=lo.device)[:, None] * m
    pos, found = searchsorted_in_window(
        keys.reshape(-1), q.reshape(-1), (lo + offs).reshape(-1),
        (hi + offs).reshape(-1), n_steps=n_steps)
    return pos.reshape(q.shape) - offs, found.reshape(q.shape)


INT64_MIN = -2**63
_LOW32 = 0xFFFFFFFF


def _order_key(values):
    """float32 -> int32 key that orders like the floats in signed int32
    order (-inf lowest, -0.0 just below +0.0)."""
    bits = values.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ INT32_MAX, bits)


def _from_order_key(key):
    bits = torch.where(key < 0, key ^ INT32_MAX, key)
    return bits.contiguous().view(torch.float32)


def segment_argmax_tie(values, tie, segment_ids, num_segments: int):
    """Per-segment argmax with an explicit tie-break key: the largest
    value wins, on a tie the smallest ``tie`` (int32 >= 0), then the
    smallest index. Returns (seg_max [num_segments] float32, seg_idx
    [num_segments] int32), seg_idx indexing ``values`` and -1 for a
    segment with no entry or a max of -inf.

    One packed pass, as the JAX reference runs it under x64: an int64 key
    ``order_key(value) << 32 | ~tie`` reduced with ``amax``, then one
    ``amin`` pass over the indices of the entries that hit their segment's
    (value, tie). Entries of value -inf can win nothing, so they are left
    out of both scatters instead of piling onto the caller's dump
    segment."""
    keep = _finite_entries(values)
    v, t = values[keep], tie[keep]
    seg = segment_ids[keep].long()
    key = (_order_key(v).to(torch.int64) << 32) | (
        (~t).to(torch.int64) & _LOW32)
    out = torch.full((num_segments,), INT64_MIN, dtype=torch.int64,
                     device=values.device)
    out = out.scatter_reduce(0, seg, key, "amax", include_self=True)
    empty = out == INT64_MIN
    seg_max = torch.where(empty, NEG,
                          _from_order_key((out >> 32).to(torch.int32)))
    seg_tie = (~out).to(torch.int32)  # the low word holds ~tie
    hit = (v == seg_max[seg]) & (t == seg_tie[seg])
    idx = torch.where(hit, keep.to(torch.int32), INT32_MAX)
    seg_idx = torch.full((num_segments,), INT32_MAX, dtype=torch.int32,
                         device=values.device)
    seg_idx = seg_idx.scatter_reduce(0, seg, idx, "amin", include_self=True)
    seg_idx = torch.where((seg_max == NEG) | (seg_idx == INT32_MAX), -1,
                          seg_idx)
    return seg_max, seg_idx


def batched_segment_argmax_tie(values, tie, segment_ids, num_segments: int):
    """Batched ``segment_argmax_tie``: inputs are [B, m] with per-instance
    segment ids in [0, num_segments], reduced as one flat offset-segment
    reduction. The returned seg_idx is local (an index into instance b's
    own [m] row; -1 if empty): within an instance the smallest flat index
    is the smallest local one. Returns ([B, num_segments],
    [B, num_segments])."""
    b, m = values.shape
    stride = num_segments + 1
    offs = torch.arange(b, dtype=torch.int64,
                        device=values.device)[:, None] * stride
    seg_max, seg_idx = segment_argmax_tie(
        values.reshape(-1), tie.reshape(-1),
        (segment_ids.long() + offs).reshape(-1), b * stride)
    seg_max = seg_max.reshape(b, stride)[:, :num_segments]
    seg_idx = seg_idx.reshape(b, stride)[:, :num_segments]
    row_offs = torch.arange(b, dtype=torch.int32,
                            device=values.device)[:, None] * m
    return seg_max, torch.where(seg_idx >= 0, seg_idx - row_offs, -1)


def segment_sum(values, segment_ids, num_segments: int):
    """``jax.ops.segment_sum`` along the leading axis (differentiable)."""
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add(0, segment_ids, values)


def segment_max(values, segment_ids, num_segments: int):
    """``jax.ops.segment_max`` along the leading axis: ``-inf`` in an empty
    segment. The gradient goes in equal shares to the entries that tie
    for their segment's max, as JAX's scatter-max rule gives it."""
    shape = (-1,) + (1,) * (values.dim() - 1)
    idx = segment_ids.long().reshape(shape).expand_as(values)
    out = values.new_full((num_segments, *values.shape[1:]), NEG)
    return out.scatter_reduce(0, idx, values, "amax", include_self=False)


def segment_argmax(values, segment_ids, num_segments: int):
    """Per-segment argmax (row index into ``values``, int32; the smallest
    on a tie); -1 for an empty segment."""
    idx = torch.arange(values.shape[0], dtype=torch.int32,
                       device=values.device)
    _, arg = segment_max_with_payload(values, idx, segment_ids, num_segments)
    return arg


def segment_softmax(logits, segment_ids, num_segments: int):
    """Numerically stable softmax within each segment (GAT-style edge
    softmax); the denominator is clamped at 1e-30."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    ex = torch.exp(logits - seg_max[segment_ids])
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp_min(denom[segment_ids], 1e-30)


def coo_spmm(row, col, val, x, n_rows: int):
    """y = A @ x for COO A (row, col, val) and dense x [n_cols, d].

    Padding entries must have ``row == n_rows`` (they are accumulated into
    a scratch segment and dropped). The GNN message-passing primitive."""
    msgs = x[col] * val[:, None]
    return segment_sum(msgs, row, n_rows + 1)[:n_rows]


def coo_sddmm(row, col, a, b):
    """Sampled dense-dense matmul: out[e] = <a[row[e]], b[col[e]]>."""
    return torch.einsum("ed,ed->e", a[row], b[col])
