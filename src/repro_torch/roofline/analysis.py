"""Roofline terms and model FLOPs, for the NVIDIA H100 (the port of the
arithmetic of the JAX package's ``roofline/analysis.py``).

Terms, per device:

  compute term    = FLOPs / peak FLOP/s
  memory term     = bytes / HBM rate
  collective term = collective bytes / link rate

The dominant term names the bound. ``H100`` holds the card's own rates:
the SXM H100 80GB HBM3 at 700 W, dense bf16 on the tensor cores and
float32 outside them (the peaks ``chip_smoke.py`` reckons its bounds
with), HBM3, NVLink per direction and the shared memory one block may
take. ``roofline_terms`` reads ``peak_flops``, ``hbm_bw`` and ``ici_bw``
(the inter-chip link) from any such table.

``useful_flops`` is the model-FLOP count (MODEL_FLOPS) of an arch on a
shape cell: 6 N D for LM training (N the parameters a token meets, D the
tokens), 2 N D for a prefill, the same plus the KV-cache reads for a
decode step, and the JAX package's analogues for the recsys, GNN and
matching families, term for term.

``shape_bytes`` and ``collective_bytes`` are the JAX package's parsers of
XLA HLO text, copied as they are: the port's dry run has no HLO (it
traces on the ``meta`` device, ``launch.dryrun``), and they stay for
reading the JAX package's dumps beside the port's records.

``plan_edge_tile`` sizes the AWAC sweep's edge tile with the JAX
package's arithmetic and divisibility contract; with no ``vmem_limit``
its budget is the shared memory one H100 block may take
(``H100["smem_bytes"]``), where the JAX package's is a TPU core's VMEM.

``attention_work`` and ``swap_work`` count the bytes and operations of
one launch of K5 (flash attention) and K4 (the router's swap search) on
given shapes: ``chip_smoke.py`` reckons the kernels' bounds with them,
and the kernels' wrappers add them to an open ``kernel_work`` counter at
each launch, and on the ``meta`` device where nothing launches (the dry
run's count of the kernels' work, which no FLOP counter sees).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import re

import numpy as np

H100 = {
    "peak_flops": 989e12,  # bf16 tensor cores, dense
    "peak_flops_f32": 67e12,  # float32 outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s, HBM3
    "ici_bw": 450e9,  # B/s, NVLink, one direction
    "smem_bytes": 227 * 1024,  # shared memory one block may take
}


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(.*?)\s+"
    r"(all-gather|all-reduce|all-to-all|reduce-scatter|collective-permute)"
    r"(-start)?\("
)

_SHAPE_RE = re.compile(
    r"(bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|pred|c64|c128)"
    r"\[([0-9,]*)\]"
)


def shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_tuple_elements(shape_str: str) -> list[str]:
    """Top-level elements of an HLO tuple shape string, or [] when the
    string is not a parenthesized tuple. Layout braces ``{1,0}`` and nested
    tuples are kept intact (commas inside either never split)."""
    s = shape_str.strip()
    if not (s.startswith("(") and s.endswith(")")):
        return []
    parts, depth, buf = [], 0, []
    for ch in s[1:-1]:
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p.strip() for p in parts]


def _is_context_scalar(element: str) -> bool:
    """Async collectives append u32[]/s32[] context scalars to the -start
    tuple; they carry no payload and must not count as collective bytes."""
    return re.fullmatch(r"[su]32\[\]\S*", element) is not None


def _start_result_bytes(shape_str: str) -> int:
    """Payload bytes of an async ``-start`` instruction: the result portion
    (second non-context top-level element of ``(operand(s), result(s),
    context...)``; itself possibly a tuple), or the shape as it is when it
    is not a tuple."""
    elements = [e for e in _split_tuple_elements(shape_str)
                if not _is_context_scalar(e)]
    if not elements:  # not a tuple: count the shape as-is
        return shape_bytes(shape_str)
    result = elements[1] if len(elements) >= 2 else elements[0]
    return shape_bytes(result)


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes by collective kind, from a compiled SPMD module's
    text: one instruction per line; a sync collective counts its full
    result shape (every element of a tuple result), an async ``-start``
    only the result portion of its tuple, and ``-done`` halves nothing."""
    out = {"all-gather": 0, "all-reduce": 0, "all-to-all": 0,
           "reduce-scatter": 0, "collective-permute": 0}
    counts = dict.fromkeys(out, 0)
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shapes, kind, is_start = m.group(1), m.group(2), bool(m.group(3))
        out[kind] += _start_result_bytes(shapes) if is_start \
            else shape_bytes(shapes)
        counts[kind] += 1
    return {"bytes": out, "counts": counts, "total": sum(out.values())}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, hw=H100) -> Roofline:
    ct = flops_per_device / hw["peak_flops"]
    mt = bytes_per_device / hw["hbm_bw"]
    lt = coll_bytes_per_device / hw["ici_bw"]
    terms = {"compute": ct, "memory": mt, "collective": lt}
    dom = max(terms, key=terms.get)
    return Roofline(ct, mt, lt, dom, flops_per_device, bytes_per_device,
                    coll_bytes_per_device)


_LANE = 128  # the tile width every edge tile is a multiple of


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class EdgeTilePlan:
    """Edge tiling of the AWAC sweep within a memory budget.

    ``te``: edge-tile width (a multiple of 128). ``cap_padded``: edge
    capacity padded to a multiple of ``te``. ``resident_bytes``: the
    working set held for the whole sweep (col/val copies, the O(n) state,
    the winner blocks). ``stream_bytes``: the double-buffered per-tile
    edge streams. ``fits``: resident + stream within the budget."""

    te: int
    cap_padded: int
    resident_bytes: int
    stream_bytes: int
    fits: bool


def plan_edge_tile(cap: int, n: int, *, target_te: int = 512,
                   vmem_limit: int | None = None) -> EdgeTilePlan:
    """Pick the sweep's edge-tile width, with the JAX package's
    arithmetic: undersized inputs are padded up to a legal tile (``cap <
    128`` becomes one 128-wide tile), and the tile shrinks below
    ``target_te`` only when the double-buffered streams would not fit
    beside the resident working set. ``te % 128 == 0`` and ``cap_padded
    % te == 0`` always. ``vmem_limit`` is the budget in bytes; None means
    ``H100["smem_bytes"]``, the shared memory one block may take."""
    if cap < 1 or n < 1:
        raise ValueError(
            f"roofline.plan_edge_tile: need cap >= 1 and n >= 1, got "
            f"cap={cap}, n={n}")
    budget = int(H100["smem_bytes"] if vmem_limit is None else vmem_limit)
    nv = _round_up(n + 2, _LANE)
    np_ = _round_up(n + 1, _LANE)
    # full col/val copies (i32 + f32) + ptr/mate_row/mate_col (i32) +
    # u/v (f32) + the four winner blocks
    cap_lane = max(_round_up(cap, _LANE), _LANE)
    resident = cap_lane * 8 + 5 * nv * 4 + 4 * np_ * 4
    te = max(min(_round_up(target_te, _LANE), cap_lane), _LANE)
    while te > _LANE and resident + 2 * 3 * te * 4 > budget:
        te -= _LANE
    cap_padded = max(_round_up(cap, te), te)
    stream = 2 * 3 * te * 4
    return EdgeTilePlan(te=te, cap_padded=cap_padded,
                        resident_bytes=resident, stream_bytes=stream,
                        fits=resident + stream <= budget)


def attention_work(b, h, hkv, s, sk, d, causal, itemsize):
    """Bytes and operations of one attention forward on these shapes: q,
    k, v read once and o written once; two products of 2 * D operations
    per (query, key) pair that the mask keeps."""
    pairs = (float(np.minimum(np.arange(1, s + 1), sk).sum()) if causal
             else float(s) * sk)
    return (itemsize * (2 * b * h * s * d + 2 * b * hkv * sk * d),
            4.0 * b * h * d * pairs)


def swap_work(assign, e: int, counts=None) -> tuple[float, float]:
    """Bytes and float32 operations of one swap-gain search on these
    inputs: the affinity, expert ids and cur read once, gain and partner
    written once; three additions for each pair of tokens on different
    experts (a pair on one expert is masked). ``counts`` [G, E] holds the
    tokens on each expert; None reads them from ``assign``."""
    g, t = assign.shape
    if counts is None:
        counts = np.stack([np.bincount(np.asarray(a.cpu()), minlength=e)
                           for a in assign])
    pairs = float(g * t * t - float((np.asarray(counts, np.float64) ** 2)
                                    .sum()))
    return g * t * (4 * e + 8) + g * t * 8, 3.0 * pairs


def balanced_counts(g: int, t: int, e: int) -> np.ndarray:
    """[G, E] tokens an expert for an assignment as even as it can be (t
    // e each, one more on the first t % e): every assignment of the AWPM
    router's rounds is so. The count ``swap_work`` takes where the ids
    cannot be read (on the ``meta`` device)."""
    row = np.full(e, t // e, dtype=np.int64)
    row[: t % e] += 1
    return np.broadcast_to(row, (g, e))


_KERNEL_WORK: list = []


@contextlib.contextmanager
def kernel_work():
    """Count the work of the hand-written kernels inside the block:
    yields {"flops", "bytes", "calls": {kernel: n}}, filled by
    ``count_kernel_work`` from every thread (the autograd engine's too)."""
    acc = {"flops": 0.0, "bytes": 0.0, "calls": collections.Counter()}
    _KERNEL_WORK.append(acc)
    try:
        yield acc
    finally:
        _KERNEL_WORK.remove(acc)


def counting_kernel_work() -> bool:
    """Whether a ``kernel_work`` block is open (a wrapper that must read
    its inputs to count its work does so only then)."""
    return bool(_KERNEL_WORK)


def count_kernel_work(name: str, nbytes: float, flops: float) -> None:
    """Add one call of kernel ``name`` to every open ``kernel_work``."""
    for acc in _KERNEL_WORK:
        acc["flops"] += float(flops)
        acc["bytes"] += float(nbytes)
        acc["calls"][name] += 1


def _lm_active_params(cfg) -> int:
    """The parameters a token meets: attention and (active) FFN of every
    layer, and the head."""
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.hd
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    if cfg.moe is not None:
        mo = cfg.moe
        ffn_active = 3 * d * (mo.d_ff_expert * mo.top_k
                              + (mo.d_ff_shared or 0))
        n_dense = mo.first_dense
        n_active = (L - n_dense) * (attn + ffn_active) \
            + n_dense * (attn + 3 * d * (mo.d_ff_dense or cfg.d_ff))
    else:
        n_active = L * (attn + 3 * d * cfg.d_ff)
    return n_active + d * cfg.vocab


def useful_flops(arch: str, shape_name: str, mode: str, cfg, shape) -> float:
    """MODEL_FLOPS of ``cfg`` on ``shape`` in ``mode`` (module docstring).
    ``arch`` and ``shape_name`` are carried for the caller's records, as
    in the JAX package; the count reads ``cfg`` and ``shape``."""
    if cfg.family == "lm":
        n_active = _lm_active_params(cfg)
        tokens = shape.d("global_batch") * (shape.d("seq_len")
                                            if mode != "decode" else 1)
        if mode == "train":
            return 6.0 * n_active * tokens
        if mode == "prefill":
            return 2.0 * n_active * tokens
        # decode also reads the KV cache: attention scores 2*B*S*H*hd*2
        kv = 4.0 * shape.d("global_batch") * shape.d("seq_len") \
            * cfg.n_heads * cfg.hd * cfg.n_layers
        return 2.0 * n_active * tokens + kv
    if cfg.family == "recsys":
        d = cfg.embed_dim
        b = shape.d("batch")
        s = cfg.seq_len
        per_tok = cfg.n_blocks * (4 * d * d + 2 * cfg.d_ff_mult * d * d
                                  + 2 * s * d)
        flops = 2.0 * b * s * per_tok
        if mode == "train":
            flops *= 3
            flops += 6.0 * b * s * d * (cfg.n_items + 2) * 0  # masked subset
            flops += 6.0 * b * s * d  # embedding
            flops += 6.0 * b * s * (cfg.n_items + 2) * d * 0.2  # masked head
        elif mode == "retrieval":
            flops += 2.0 * shape.d("n_candidates") * d
        else:
            flops += 2.0 * b * d * (cfg.n_items + 2)
        return flops
    if cfg.family == "gnn":
        from repro_torch.data.graphs import (
            TRIPLET_FACTOR,
            graphcast_sizes,
            sampled_sizes,
        )

        n, e = shape.d("n_nodes", 1), shape.d("n_edges", 1)
        if shape.name == "minibatch_lg":
            n, e = sampled_sizes(shape.d("batch_nodes"),
                                 (shape.d("fanout1"), shape.d("fanout2")))
        if shape.name == "molecule":
            n, e = n * shape.d("batch"), e * shape.d("batch")
        d = cfg.d_hidden
        L = cfg.n_layers
        train_mult = 3.0  # fwd + bwd
        if cfg.kind == "graphsage":
            per_layer = 2 * e * d + 4 * n * d * d
        elif cfg.kind == "dimenet":
            p_tri = TRIPLET_FACTOR * e
            nb = cfg.opt("n_bilinear", 8)
            per_layer = 2 * p_tri * nb * d * d / 8 + 8 * e * d * d
        elif cfg.kind == "equiformer_v2":
            k_comp = (cfg.opt("l_max", 6) + 1) ** 2
            per_layer = 2 * e * k_comp * d * d + 4 * e * d * d
        else:  # graphcast: processor on the MESH edges
            sz = graphcast_sizes(n)
            per_layer = 2 * sz["e_mesh"] * 8 * d * d
        return train_mult * L * per_layer
    if cfg.family == "matching":
        # per AWAC round: relabel+join O(m log m) + O(n) selection
        n = shape.d("n")
        m = n * shape.d("avg_degree")
        return (m * (2 + math.log2(max(m, 2))) + 8 * n) * 8
    return 0.0
