"""equiformer-v2 [arXiv:2306.12059]: 12 layers, d_hidden=128, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN equivariant graph attention."""
from repro_torch.configs.base import GNNConfig


def config():
    return GNNConfig("equiformer-v2", "equiformer_v2", n_layers=12, d_hidden=128,
                     extra=(("l_max", 6), ("m_max", 2), ("n_heads", 8)))


def reduced():
    return GNNConfig("equiformer-v2-smoke", "equiformer_v2", n_layers=2,
                     d_hidden=16, extra=(("l_max", 2), ("m_max", 1),
                                         ("n_heads", 4)))
