"""Generators on the device, each seeded from the run's seed and a
purpose, so that every draw of a run follows from ``--seed`` alone and no
two purposes share a stream."""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and the draw's name and indices
    (any whole ``seed``, negative or past 64 bits included)."""
    text = ":".join(str(p) for p in (int(seed), *parts)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *parts))
    return g
