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

The HLO parsers (``shape_bytes``, ``collective_bytes``) and the edge-tile
planner ``plan_edge_tile`` belong to the dry run, which is not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import math

H100 = {
    "peak_flops": 989e12,  # bf16 tensor cores, dense
    "peak_flops_f32": 67e12,  # float32 outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s, HBM3
    "ici_bw": 450e9,  # B/s, NVLink, one direction
    "smem_bytes": 227 * 1024,  # shared memory one block may take
}


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
