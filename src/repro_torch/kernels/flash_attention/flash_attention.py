"""Flash attention forward (GQA, causal or full), K5: the wrapper of its
two CUDA kernels, in the JAX package's kernel layout q [B, H, S, D], k and
v [B, Hkv, Sk, D]. bfloat16 inputs go to ``csrc/flash_attention_tc.cu``
(both products on the tensor cores), float32 inputs to
``csrc/flash_attention.cu`` (the CUDA cores, full float32).

A CUDA tensor always goes to a kernel, or the wrapper raises; a CPU tensor
goes to the plain version ``attention_plain``, which the tests hold to the
JAX reference and the chip check holds the kernels to. The kernels take
each tensor's strides (the last dimension contiguous; for bfloat16 the
others multiples of 8 elements and the data 16-byte aligned, as TMA
needs), so views such as the model's [B, S, H, D] projections swapped to
[B, H, S, D] go in without a copy; the output keeps q's layout. Unlike the
TPU kernel, S and Sk need not be multiples of a tile: the kernels mask the
ragged edge themselves.

``attention_plain`` is the counterpart of the JAX package's
``kernels/flash_attention/ref.py`` ``attention_ref``: float32 softmax, kv
head ``h // group``, the row max clamped to 0 where a row is all -inf,
``l`` clamped at 1e-30, output in q's dtype. It scales the scores after
the product, as the reference and the bfloat16 kernel do; the float32
kernel scales q before it, as the TPU kernel did.

A ``meta`` tensor launches nothing: under the kernel's own checks the
wrapper returns the kernel's output as a ``meta`` tensor in q's layout
and adds the kernel's work (``roofline.analysis.attention_work``) to an
open ``kernel_work`` counter, as each launch adds it; nothing is counted
as a launch. The dry run traces the cells that serve or train with
``attention_impl="cuda"`` through it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.roofline.analysis import attention_work, count_kernel_work

NEG = float("-inf")

#: launches of either CUDA kernel since the last
#: ``backend.reset_launch_counts``
launches = 0

#: head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q [B, H, S, D] and k, v [B, Hkv, Sk, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B, H, S, D]; k, v [B, Hkv, Sk, D] with H % Hkv == 0, float32 or
    bfloat16. Returns [B, H, S, D] in q's dtype, laid out as q is."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if q.device.type == "meta":
        _check_kernel_shapes(q, k)
        o = _empty_like_layout(q)
        _count(q, k, causal)
        return o
    return _launch(q, k, v, causal)


def _check_kernel_shapes(q, k):
    d, s, sk = q.shape[3], q.shape[2], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if s == 0 or sk == 0:
        raise ValueError(f"empty sequence: S={s}, Sk={sk}")


def _count(q, k, causal):
    b, h, s, d = q.shape
    count_kernel_work("flash_attention", *attention_work(
        b, h, k.shape[1], s, k.shape[2], d, causal, q.element_size()))


def _launch(q, k, v, causal):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on a CUDA device, got "
                         f"{q.device}")
    b, h, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _check_kernel_shapes(q, k)
    o = _empty_like_layout(q)
    tensors = (("q", q), ("k", k), ("v", v), ("o", o))
    for name, x in tensors:
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension, got strides {x.stride()}")
        if q.dtype == torch.bfloat16 and (
                any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: the bfloat16 kernel's TMA loads need strides that "
                f"are multiples of 8 elements and 16-byte aligned data, got "
                f"strides {x.stride()}")
    strides = (ctypes.c_longlong * 12)(
        *(st for _, x in tensors for st in x.stride()[:3]))
    entry = _ENTRIES[q.dtype]
    lib = backend.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), b, h, hkv, s, sk, d, strides,
                              int(causal), 1.0 / (d ** 0.5), stream)
    launches += 1
    backend.check(err, entry)
    _count(q, k, causal)
    return o


def _empty_like_layout(q):
    """An uninitialised tensor of q's shape and dtype whose axes are nested
    in the order of q's strides, with no gaps: [B, S, H, D] in memory for a
    q swapped from the model's layout, even where q is a view with gaps."""
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    o = torch.empty([q.shape[i] for i in order], dtype=q.dtype,
                    device=q.device)
    return o.permute([order.index(i) for i in range(4)])


def attention_plain(q, k, v, causal: bool = True):
    """q [B, H, S, D]; k, v [B, Hkv, Sk, D]. Returns [B, H, S, D]."""
    _, h, s, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = 1.0 / (d ** 0.5)
    s_ = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        s_ = s_.masked_fill(qpos < kpos, NEG)
    m = s_.amax(dim=-1, keepdim=True)
    m = torch.where(m > NEG, m, torch.zeros_like(m))
    p = torch.exp(s_ - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float())
    return (o / l.clamp_min(1e-30)).to(q.dtype)
