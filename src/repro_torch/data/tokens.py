"""Deterministic synthetic token pipeline for LM training (a numpy copy of
the JAX package's ``data/tokens.py``, so both produce the same streams).

Stateless per-step generation keyed on (seed, step, host_index), so a
restart from a checkpoint reproduces the same stream; each host can
generate only its data shard (host_index/host_count)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def batch(self, step: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )
        # zipf-ish marginal + markov-ish structure so the loss is learnable
        base = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        tokens = (base % self.vocab).astype(np.int32)
        tokens[:, 1::2] = (tokens[:, 0:-1:2] * 7 + 13) % self.vocab  # learnable
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].astype(np.int32),
            "mask": np.ones((self.local_batch, self.seq_len), np.float32),
        }
