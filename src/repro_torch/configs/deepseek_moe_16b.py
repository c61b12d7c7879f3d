"""deepseek-moe-16b [arXiv:2401.06066]: 28L d_model=2048 16H d_ff(expert)=1408
vocab=102400, 64 routed top-6 + 2 shared, fine-grained, first layer dense
(d_ff=10944)."""
from repro_torch.configs.base import LMConfig, MoECfg


def config(router: str = "topk"):
    return LMConfig("deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
                    n_kv_heads=16, d_ff=10944, vocab=102400, head_dim=128,
                    qkv_bias=False, rope_theta=1e4,
                    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408,
                               n_shared=2, d_ff_shared=2816, first_dense=1,
                               d_ff_dense=10944, router=router))


def reduced(router: str = "topk"):
    return LMConfig("deepseek-moe-16b-smoke", n_layers=3, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=160, vocab=512, head_dim=16,
                    qkv_bias=False, dtype="float32",
                    moe=MoECfg(n_experts=8, top_k=6, d_ff_expert=24,
                               n_shared=2, d_ff_shared=48, first_dense=1,
                               d_ff_dense=160, router=router))
