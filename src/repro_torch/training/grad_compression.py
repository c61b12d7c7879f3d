"""Gradient compression for bandwidth-bound data parallelism (the port of
the JAX package's ``training/grad_compression.py``).

Two composable schemes, both with error feedback, so that the compression
noise is unbiased over time (Karimireddy et al., arXiv:1901.09847):

- int8 quantization: a per-tensor symmetric scale; the all-reduce runs on
  a quarter of the bytes and the sum is decoded after it;
- top-k sparsification: the k largest |g| of each tensor are kept (values
  and indices are what would be exchanged); the rest is fed back into the
  next step.

Gradients are a tree of tensors: a mapping (a model's gradients by
parameter name, as ``training.loop.loss_and_grads`` gives them), a tuple
or a list of them, nested. ``CompressedState`` carries the error-feedback
residuals between steps, in the same tree.

``compress_int8_psum`` takes a ``torch.distributed`` process group where
the JAX package takes the name of a ``shard_map`` axis: an int32
all-reduce SUM of the int8 payloads, a MAX of the scales, and a division
by the group's size, in JAX's order.

The arithmetic is that of the compiled JAX step, to the bit, on the card
as on the CPU. XLA rewrites a division by a constant into a product with
its float32 reciprocal and fuses a product followed by a sum into one
fused multiply-add (rounded once), so:

  - ``scale = fma(max|x|, f32(1/127), 1e-12)`` (``_fma_f32``);
  - ``x / scale`` stays a true division: ``scale`` is no constant (the
    divisor is a tensor on the operand's device, where a Python number
    would make the card multiply by its reciprocal);
  - ``torch.round`` rounds half to even, as ``jnp.round`` does;
  - the residual ``gc - q * scale`` is rounded once;
  - the mean is ``sum * shared_scale * f32(1 / group size)``.

JAX run op by op, outside ``jit``, divides by 127 and rounds the product
and the sum apart, and its scales then differ in the last place.
 ``topk_sparsify`` keeps
the k largest magnitudes with ties at the k-th going to the lowest
indices, as ``jax.lax.top_k`` does (``torch.topk`` promises no order among
ties).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import torch
import torch.distributed as dist


class CompressedState(NamedTuple):
    residual: object  # a tree like the gradients


def tree_leaves(tree) -> list:
    """The leaves of a tree of mappings, tuples and lists, in the order
    ``jax.tree`` takes them: a mapping's in sorted key order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure over ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def init_state(grads_like) -> CompressedState:
    return CompressedState(tree_unflatten(
        grads_like, [torch.zeros_like(g) for g in tree_leaves(grads_like)]))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to a float32 0-dim tensor on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _fma_f32(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add rounds it. The product is exact in float64; the sum is
    rounded there to odd (the neighbour with an odd last bit when it is
    inexact, from its error by TwoSum), so that rounding it to float32
    rounds the exact value once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                           .to(s.dtype))
    return torch.where((err != 0) & even, away, s).float()


def quantize_int8(x):
    """(int8 payload, float32 scale): ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round(x / scale), -127, 127)``, in the compiled reference's
    arithmetic (module docstring)."""
    inv127 = _f32(1.0, x) / _f32(127.0, x)
    scale = _fma_f32(x.abs().max(), inv127, _f32(1e-12, x))
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


class Int8Exchange(NamedTuple):
    """One tensor's error-feedback int8 all-reduce, step by step."""

    payload: torch.Tensor  # int8, this rank's quantized gradient
    scale: torch.Tensor  # this rank's scale
    summed: torch.Tensor  # int32, the payloads' sum over the group
    shared_scale: torch.Tensor  # the largest scale of the group
    mean: torch.Tensor  # float32, the decoded mean
    residual: torch.Tensor  # what the payload missed, for the next step


def int8_allreduce(g, r, group=None) -> Int8Exchange:
    """Quantize ``g + r``, sum the payloads over ``group`` in int32 (the
    numerics of a backend that sends int8 and widens at the reducer) and
    decode the sum with the group's largest scale (a conservative shared
    scale), divided by the group's size."""
    gc = g + r
    q, scale = quantize_int8(gc)
    # gc - q * scale rounded once: the product and the difference are
    # exact in float64 (|q| <= 127 takes 7 bits, |gc - q * scale| <=
    # scale / 2)
    new_r = (gc.double() - q.double() * scale.double()).float()
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    shared = scale.clone()
    dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
    inv_size = _f32(1.0, shared) / _f32(dist.get_world_size(group), shared)
    mean = summed.to(torch.float32) * shared * inv_size
    return Int8Exchange(q, scale, summed, shared, mean, new_r)


def compress_int8_psum(grads, state: CompressedState, group=None):
    """Error-feedback int8 all-reduce of a gradient tree over ``group``
    (None: the default group). Every rank of the group calls it with the
    same tree. Returns (the decoded means, the new state)."""
    out = [int8_allreduce(g, r, group) for g, r in
           zip(tree_leaves(grads), tree_leaves(state.residual))]
    return (tree_unflatten(grads, [e.mean for e in out]),
            CompressedState(tree_unflatten(grads,
                                           [e.residual for e in out])))


def topk_indices(x, k_frac: float = 0.01) -> torch.Tensor:
    """The flat indices, in increasing order, of the k = max(1, int(k_frac
    * x.numel())) largest |x|; ties at the k-th magnitude go to the lowest
    indices."""
    a = x.reshape(-1).abs()
    k = max(1, int(k_frac * a.shape[0]))
    kth = torch.topk(a, k, sorted=False).values.min()
    above = torch.nonzero(a > kth).reshape(-1)
    tied = torch.nonzero(a == kth).reshape(-1)[:k - above.numel()]
    return torch.sort(torch.cat([above, tied])).values


def topk_sparsify(x, k_frac: float = 0.01):
    """Keep the top-k |values|; returns (dense reconstruction, residual)."""
    flat = x.reshape(-1)
    idx = topk_indices(x, k_frac)
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    kept = kept.reshape(x.shape)
    return kept, x - kept


def compress_topk(grads, state: CompressedState, k_frac: float = 0.01):
    """Error-feedback top-k (the exchange would carry k values and
    indices instead of the dense tensor; this returns the dense
    reconstruction for the optimizer) and the new state."""
    out = [topk_sparsify(g + r, k_frac) for g, r in
           zip(tree_leaves(grads), tree_leaves(state.residual))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            CompressedState(tree_unflatten(grads, [o[1] for o in out])))
