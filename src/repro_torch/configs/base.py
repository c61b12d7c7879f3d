"""Config dataclasses of the language-model, recsys and GNN families, and
the recsys and GNN shape cells (copies of the JAX package's
``configs/base.py``; plain frozen dataclasses).

``MoECfg`` configures the MoE layers of ``models/moe.py``: its ``router``
is ``"topk"`` (the published baseline) or ``"awpm"`` (the matching
router, whose swap search runs the CUDA kernel K4 on the card); the other
fields are read as the JAX package reads them. ``LMConfig.attention_impl``
uses the port's vocabulary: ``"torch"`` (the plain version, counterpart of
JAX's ``"xla"``) or ``"cuda"`` (the hand-written kernel, counterpart of
``"pallas"``). ``remat``, ``scan`` and ``loss_chunks`` are carried so that
a JAX config converts field for field; the port's eager one-device path
does not read them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

ATTENTION_IMPLS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    router: str = "topk"  # "topk" (paper-faithful baseline) | "awpm" (ours)
    capacity_factor: float = 1.25
    first_dense: int = 0  # leading dense layers (deepseek-moe style)
    d_ff_dense: int = 0  # hidden of the leading dense layers
    shared_gate: bool = False  # sigmoid gate on shared expert (qwen2-moe)
    router_swap_rounds: int = 4  # AWPM router 4-cycle improvement rounds
    router_block: int = 2048  # AWPM routing block (per-shard granularity)
    dispatch_groups: int = 0  # top-k grouped dispatch (0 = global, baseline)
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    moe: MoECfg | None = None
    dtype: str = "bfloat16"
    remat: bool = True
    scan: bool = True
    loss_chunks: int = 0
    attention_impl: str = "torch"  # "torch" | "cuda"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {self.attention_impl!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def family(self) -> str:
        return "lm"


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # graphsage | dimenet | equiformer_v2 | graphcast
    n_layers: int
    d_hidden: int
    extra: tuple[tuple[str, Any], ...] = ()
    dtype: str = "float32"
    remat: bool = True

    def opt(self, key, default=None):
        return dict(self.extra).get(key, default)

    @property
    def family(self) -> str:
        return "gnn"


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str  # bert4rec
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    n_items: int = 1_000_000
    d_ff_mult: int = 4
    dtype: str = "float32"

    @property
    def padded_items(self) -> int:
        """Item-table rows (n_items + mask + pad), rounded up to a multiple
        of 512 as the JAX package rounds them for its row-sharded table."""
        return -(-(self.n_items + 2) // 512) * 512

    @property
    def family(self) -> str:
        return "recsys"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: for the recsys family its ``batch`` and
    ``n_candidates``; for the GNN family ``n_nodes``, ``n_edges``,
    ``d_feat``, ``batch_nodes`` and fanouts (sampled) or ``batch``
    (molecules)."""

    name: str
    mode: str
    dims: tuple[tuple[str, int], ...]

    def d(self, key, default=0) -> int:
        return dict(self.dims).get(key, default)


#: the serving cells of the JAX package's ``RECSYS_SHAPES`` (its
#: ``train_batch`` comes with training)
RECSYS_SHAPES = (
    ShapeSpec("serve_p99", "serve", (("batch", 512),)),
    ShapeSpec("serve_bulk", "serve", (("batch", 262144),)),
    ShapeSpec("retrieval_cand", "retrieval",
              (("batch", 1), ("n_candidates", 1_000_000))),
)


def recsys_shape(name: str) -> ShapeSpec:
    """The recsys shape cell called ``name``."""
    for spec in RECSYS_SHAPES:
        if spec.name == name:
            return spec
    raise KeyError(f"unknown recsys shape {name!r}")


#: the JAX package's ``GNN_SHAPES``: Cora (full graph), Reddit (sampled
#: blocks from 1,024 seeds at fanouts 15/10), ogbn-products (full graph)
#: and batches of 128 small molecules
GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              (("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433))),
    ShapeSpec("minibatch_lg", "train",
              (("n_nodes", 232965), ("n_edges", 114615892),
               ("batch_nodes", 1024), ("fanout1", 15), ("fanout2", 10),
               ("d_feat", 602))),
    ShapeSpec("ogb_products", "train",
              (("n_nodes", 2449029), ("n_edges", 61859140),
               ("d_feat", 100))),
    ShapeSpec("molecule", "train",
              (("n_nodes", 30), ("n_edges", 64), ("batch", 128),
               ("d_feat", 16))),
)


def gnn_shape(name: str) -> ShapeSpec:
    """The GNN shape cell called ``name``."""
    for spec in GNN_SHAPES:
        if spec.name == name:
            return spec
    raise KeyError(f"unknown GNN shape {name!r}")
