"""dimenet [arXiv:2003.03123]: 6 blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6 — directional (triplet) message passing."""
from repro_torch.configs.base import GNNConfig


def config():
    return GNNConfig("dimenet", "dimenet", n_layers=6, d_hidden=128,
                     extra=(("n_bilinear", 8), ("n_spherical", 7),
                            ("n_radial", 6)))


def reduced():
    return GNNConfig("dimenet-smoke", "dimenet", n_layers=2, d_hidden=16,
                     extra=(("n_bilinear", 4), ("n_spherical", 3),
                            ("n_radial", 4)))
