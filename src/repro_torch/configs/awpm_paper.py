"""The paper's own 'architecture': distributed AWPM matching itself, as a
config of the registry beside the model archs (its shape cells are
``MATCHING_SHAPES``)."""
from repro_torch.configs.base import MatchingConfig


def config():
    return MatchingConfig("awpm-matching", n=4_194_304, avg_degree=16)


def reduced():
    return MatchingConfig("awpm-matching-smoke", n=128, avg_degree=5)
