"""graphcast [arXiv:2212.12794]: 16 processor layers, d_hidden=512,
mesh_refinement=6, sum aggregation, n_vars=227 (encoder-processor-decoder)."""
from repro_torch.configs.base import GNNConfig


def config():
    return GNNConfig("graphcast", "graphcast", n_layers=16, d_hidden=512,
                     extra=(("mesh_refinement", 6), ("n_vars", 227)))


def reduced():
    return GNNConfig("graphcast-smoke", "graphcast", n_layers=2, d_hidden=24,
                     extra=(("mesh_refinement", 2), ("n_vars", 12)))
