"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B]: 80L d_model=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064 — QKV bias."""
from repro_torch.configs.base import LMConfig


def config():
    return LMConfig("qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
                    n_kv_heads=8, d_ff=49152, vocab=152064, head_dim=128,
                    qkv_bias=True, rope_theta=1e6)


def reduced():
    return LMConfig("qwen1.5-110b-smoke", n_layers=3, d_model=96, n_heads=8,
                    n_kv_heads=2, d_ff=256, vocab=512, head_dim=16,
                    qkv_bias=True, dtype="float32")
