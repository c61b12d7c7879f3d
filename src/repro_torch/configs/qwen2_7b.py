"""qwen2-7b [arXiv:2407.10671]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias."""
from repro_torch.configs.base import LMConfig


def config():
    return LMConfig("qwen2-7b", n_layers=28, d_model=3584, n_heads=28,
                    n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
                    qkv_bias=True, rope_theta=1e6)


def reduced():
    return LMConfig("qwen2-7b-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=192, vocab=512, head_dim=16,
                    qkv_bias=True, dtype="float32")
