"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional sequence encoder; 1M-item table for the retrieval cell."""
from repro_torch.configs.base import RecSysConfig


def config():
    return RecSysConfig("bert4rec", "bert4rec", embed_dim=64, n_blocks=2,
                        n_heads=2, seq_len=200, n_items=1_000_000)


def reduced():
    return RecSysConfig("bert4rec-smoke", "bert4rec", embed_dim=16, n_blocks=2,
                        n_heads=2, seq_len=16, n_items=500)
