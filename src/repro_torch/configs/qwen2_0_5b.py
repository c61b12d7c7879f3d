"""qwen2-0.5b [arXiv:2407.10671]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias, tied embeddings."""
from repro_torch.configs.base import LMConfig


def config():
    return LMConfig("qwen2-0.5b", n_layers=24, d_model=896, n_heads=14,
                    n_kv_heads=2, d_ff=4864, vocab=151936, head_dim=64,
                    qkv_bias=True, tie_embeddings=True, rope_theta=1e6)


def reduced():
    return LMConfig("qwen2-0.5b-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
                    qkv_bias=True, tie_embeddings=True, dtype="float32")
