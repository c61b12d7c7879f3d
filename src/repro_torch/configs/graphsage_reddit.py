"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10."""
from repro_torch.configs.base import GNNConfig


def config():
    return GNNConfig("graphsage-reddit", "graphsage", n_layers=2, d_hidden=128,
                     extra=(("aggregator", "mean"), ("sample_sizes", (25, 10))))


def reduced():
    return GNNConfig("graphsage-reddit-smoke", "graphsage", n_layers=2,
                     d_hidden=16,
                     extra=(("aggregator", "mean"), ("sample_sizes", (5, 3))))
