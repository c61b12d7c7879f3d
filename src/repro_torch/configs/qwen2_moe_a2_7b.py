"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H
d_ff(expert)=1408 vocab=151936, 60 routed top-4 + 4 shared (gated).
``router`` selects the paper-faithful top-k baseline or the AWPM router
(the paper's matching technique; DESIGN.md §4)."""
from repro_torch.configs.base import LMConfig, MoECfg


def config(router: str = "topk"):
    return LMConfig("qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
                    n_kv_heads=16, d_ff=5632, vocab=151936, head_dim=128,
                    qkv_bias=True, rope_theta=1e6,
                    moe=MoECfg(n_experts=60, top_k=4, d_ff_expert=1408,
                               n_shared=4, d_ff_shared=5632, shared_gate=True,
                               router=router))


def reduced(router: str = "topk"):
    return LMConfig("qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
                    qkv_bias=True, dtype="float32",
                    moe=MoECfg(n_experts=6, top_k=4, d_ff_expert=32,
                               n_shared=2, d_ff_shared=64, shared_gate=True,
                               router=router))
