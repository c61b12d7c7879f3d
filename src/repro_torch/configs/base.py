"""Config dataclasses of the language-model and recsys families, and the
recsys shape cells (copies of the JAX package's ``configs/base.py``;
plain frozen dataclasses).

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
    """One input-shape cell; for the recsys family its ``batch`` and
    ``n_candidates``."""

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
